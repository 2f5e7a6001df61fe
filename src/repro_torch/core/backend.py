"""Pluggable execution backends (DESIGN.md §2, §6), PyTorch port.

The scheduler is execution-agnostic: it announces *kernel completions* in
simulated-clock order and an ``ExecutionBackend`` decides what (if anything)
actually runs.  Two implementations:

  SimBackend        pure timing study — every hook is a no-op; this module
                    imports no torch at module level, so the simulation-only
                    path stays free of it.
  TorchRealBackend  real token generation on a device-resident slot-pool KV
                    cache (the port of the reference's ``JaxRealBackend``).

The seam (``ExecutionBackend``, ``SimBackend``, ``TokenCallback`` and the
bucketing helpers) is a copy of the reference's, logic unchanged; see that
module for the hook protocol.
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.core.contention import (MemoryPressureEstimator,
                                         co_execution_rates)
from repro_torch.core.faults import (AllocationFault, FaultError,
                                     FaultInjector, FlowFault,
                                     InvariantViolation)
from repro_torch.core.prefixcache import PrefixCache
from repro_torch.core.requests import Request

TokenCallback = Callable[[Request, int], None]


def _prompt_key(req: Request) -> tuple:
    """Token-ID key of a request's prompt (the exactness currency of the
    prefix index): a hit is only ever claimed on exact token equality."""
    import numpy as np
    return tuple(int(t) for t in
                 np.asarray(req.tokens).reshape(-1)[:req.prompt_len])


class ExecutionBackend:
    """Interface the scheduler drives through kernel-completion hooks."""

    def register(self, req: Request,
                 on_token: Optional[TokenCallback] = None) -> None:
        pass

    def prefix_hit(self, req: Request) -> int:
        """Longest reusable cached-prefix length for this request's prompt.

        Consulted by the scheduler at ARRIVAL (before prefill kernels are
        built), so a hit shrinks the request's prefill ETC and every
        downstream estimate — piggyback horizons, HEG kernel timing — sees
        only the real remaining tail.  0 = cold prefill."""
        return 0

    def prefill_chunk(self, req: Request, seq_start: int, tokens: int,
                      now: float) -> None:
        pass

    def prefill_done(self, req: Request, now: float) -> None:
        pass

    def decode_run(self, reqs: List[Request], n_steps: int,
                   now: float) -> None:
        """Scheduler announcement: the coming ``n_steps`` decode iterations
        will run with exactly this membership (no arrival/completion/finish
        can change the batch before they commit)."""
        pass

    def request_preempt(self, now: float) -> None:
        """Scheduler notice that a higher-priority event (reactive arrival,
        prefill join) truncated the announced run: cancel every decode
        segment not yet launched.  Already-produced tokens stay buffered —
        the scheduler still commits them via ``decode_iteration`` (the
        truncated plan's remaining replay steps)."""
        pass

    def decode_iteration(self, reqs: List[Request], now: float) -> None:
        pass

    def finish(self, req: Request, now: float) -> None:
        pass

    def release(self, reqs: List[Request], now: float) -> None:
        pass

    # -- failure model (DESIGN.md §12) ---------------------------------------
    def deadline_expired(self, req: Request, now: float) -> bool:
        """True once ``req`` has overrun its (relative) deadline; consulted
        by the scheduler's per-turn poll.  The flow is then aborted at the
        next segment boundary with the ``timed_out`` terminal status."""
        return req.deadline is not None \
            and now - req.arrival_time > req.deadline

    def take_flow_faults(self) -> List[FlowFault]:
        """Drain flow-attributable failures parked since the last poll
        (hook exception, allocation failure, flow-targeted device fault).
        The scheduler quarantines each envelope's flow as ``failed``."""
        return []

    def quarantine_flow(self, req: Request, now: float) -> None:
        """Retire ONE failed/expired flow's execution state — slot, donor
        refcounts, prefix pins — while keeping every other flow's committed
        run (buffered replay rows included) intact."""
        self.finish(req, now)

    def evict_prefix_leaves(self) -> int:
        """Degradation-ladder rung 1: force-evict unpinned prefix-cache
        leaves; returns the number of off-pool KV rows freed."""
        return 0

    def kv_store_rows(self) -> int:
        """Off-pool KV rows held by the prefix snapshot store (counted as
        row-equivalents by admission occupancy)."""
        return 0

    def validate(self, strict: bool = False) -> List[str]:
        """Audit internal accounting invariants; returns the violations
        found (empty = clean).  ``strict=True`` raises
        ``InvariantViolation`` instead of returning them."""
        return []

    def output_tokens(self, req_id: int) -> list:
        return []

    def stats(self) -> dict:
        return {}


class SimBackend(ExecutionBackend):
    """Timing-only backend: the discrete-event simulator is the execution.

    It still models shared-prefix hit accounting (DESIGN.md §10) with the
    SAME radix index, driven at the SAME scheduler instants as the real
    backend — match at arrival, insert at prefill completion, pin while in
    flight — so sim and real traces stay equal with the cache on or off.
    ``max_len`` mirrors the real backend's ring capacity (its wrap gate:
    a donor whose row could wrap past ``max_len`` is never indexed, since
    wrap would overwrite the donated prefix); ``None`` leaves insertion
    ungated for pure-sim studies."""

    name = "sim"

    def __init__(self, *, prefix_cache: bool = True,
                 prefix_cache_tokens: Optional[int] = None,
                 prefix_block: int = 1, max_len: Optional[int] = None):
        from repro_torch.core.prefixcache import DEFAULT_CAPACITY_TOKENS
        self._prefix: Optional[PrefixCache] = PrefixCache(
            prefix_cache_tokens or DEFAULT_CAPACITY_TOKENS,
            block=prefix_block) if prefix_cache else None
        self.max_len = max_len
        self._hit_node: Dict[int, object] = {}
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0

    def prefix_hit(self, req: Request) -> int:
        if self._prefix is None or req.tokens is None:
            return 0
        self.prefix_prompt_tokens += req.prompt_len
        hit, node = self._prefix.match(_prompt_key(req),
                                       max_hit=req.prompt_len - 1)
        if hit <= 0 or node is None:
            return 0
        old = self._hit_node.pop(req.id, None)
        if old is not None:  # re-arrival of the same id: drop the stale pin
            self._prefix.unpin(old)
        self._prefix.pin(node)
        self._hit_node[req.id] = node
        self.prefix_hits += 1
        self.prefix_hit_tokens += hit
        return hit

    def prefill_done(self, req: Request, now: float) -> None:
        if self._prefix is None or req.tokens is None:
            return
        if self.max_len is not None \
                and req.prompt_len + req.max_new_tokens > self.max_len:
            return  # wrap gate (mirrors JaxRealBackend)
        self._prefix.insert(_prompt_key(req))

    def finish(self, req: Request, now: float) -> None:
        node = self._hit_node.pop(req.id, None)
        if node is not None and self._prefix is not None:
            self._prefix.unpin(node)

    def release(self, reqs: List[Request], now: float) -> None:
        for r in reqs:
            self.finish(r, now)

    def evict_prefix_leaves(self) -> int:
        # drive the SAME index operation as the real backend so the
        # admission ladder mutates sim and real prefix state identically;
        # the sim holds no physical KV, so 0 rows are freed
        if self._prefix is not None:
            self._prefix.evict_unpinned()
        return 0

    def validate(self, strict: bool = False) -> List[str]:
        problems: List[str] = []
        if self._prefix is not None:
            want: Dict[int, int] = {}
            for node in self._hit_node.values():
                want[id(node)] = want.get(id(node), 0) + 1
            for rid, node in self._hit_node.items():
                if node.refs < want[id(node)]:
                    problems.append(
                        f"prefix pin undercount: node {node.nid} refs "
                        f"{node.refs} < {want[id(node)]} pinning flows")
        if strict and problems:
            raise InvariantViolation("; ".join(problems))
        return problems

    def stats(self) -> dict:
        out = {"prefix_hits": self.prefix_hits,
               "prefix_hit_tokens": self.prefix_hit_tokens,
               "prefix_hit_rate": self.prefix_hit_tokens
               / max(self.prefix_prompt_tokens, 1)}
        if self._prefix is not None:
            out.update(self._prefix.stats())
        return out


def _pow2_buckets(n: int) -> List[int]:
    """Descending power-of-2 decomposition of a chunk length (96 -> [64, 32]):
    any chunk is covered by O(log n) jit-compiled shapes instead of one
    compilation per distinct (request, chunk) shape."""
    out, b = [], 1
    if n <= 0:
        return out
    while b * 2 <= n:
        b *= 2
    while n > 0:
        while b > n:
            b //= 2
        out.append(b)
        n -= b
    return out


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class TorchRealBackend(ExecutionBackend):
    """Real execution on a device-resident slot-pool KV cache (PyTorch).

    The counterpart of the reference's ``JaxRealBackend`` behind the same
    seam, driven by the same scheduler hooks:

    * prefill is in-pool and zero-copy (DESIGN.md §7): the slot is taken at
      prefill START, the reused row is invalidated in place
      (``kvcache.reset_row``), and every pow-2 bucketed sub-chunk runs
      ``models.extend`` on a view of the live row, so prompt K/V are written
      once, straight into the pool.  The prompt is uploaded once at
      ``register`` (pow-2 padded) and sliced on the device; the first output
      token is fetched in ONE host sync at ``prefill_done``;
    * the pool, each slot's last token and the active-slot mask stay on the
      device; the model updates them in place where the reference donated
      its buffers;
    * a scheduler-announced ``decode_run(reqs, n_steps)`` runs lazily in
      abortable segments of ``decode_segment_steps`` iterations (DESIGN.md
      §8), each as pow-2 ``models.decode_run`` calls whose token block is
      fetched to the host ONCE per segment; ``decode_iteration`` replays
      from it;
    * every decode dispatch is elastic (DESIGN.md §9): the leading pow-2
      live rows of the pool, over the pow-2 live KV prefix.

    PyTorch runs eagerly, so nothing is compiled; ``jit_compilations``
    counts the first-seen shape keys the reference would have compiled, and
    ``decode_device_calls``/``host_syncs`` count as in the reference.

    Not ported yet, each refused by name: the prefix cache
    (``prefix_cache=True``), fault injection (``faults=``), and the
    ``device_resident=False`` / ``in_pool_prefill=False`` baselines.
    Per-flow isolation of ``on_token`` hook failures, deadlines, the
    bounded pool (``pool_slots_max``) and surgical quarantine of a cancelled
    or failed flow are kept: the scheduler drives them.
    """

    name = "torch"

    def __init__(self, cfg, params, *, pool_slots: int, max_len: int = 512,
                 dtype=None, device=None, device_resident: bool = True,
                 in_pool_prefill: Optional[bool] = None,
                 abortable_runs: bool = True,
                 decode_segment_steps: int = 8,
                 elastic_decode: bool = True,
                 prefix_cache: bool = False,
                 kv_dtype: str = "bf16",
                 kernel_backend: str = "cuda",
                 pool_slots_max: Optional[int] = None,
                 isolate_flow_faults: bool = True,
                 faults: Optional[FaultInjector] = None):
        import numpy as np
        import torch
        from repro_torch.models import cache_bytes, check_supported, \
            init_cache
        from repro_torch.models.transformer import KERNEL_BACKENDS
        check_supported(cfg)
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8': {kv_dtype}")
        if kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(f"kernel_backend must be one of "
                             f"{KERNEL_BACKENDS}: {kernel_backend!r}")
        if prefix_cache:
            raise NotImplementedError(
                "the prefix cache is not ported yet (ROADMAP.md queue 1, "
                "item 5d: prefix-cache hooks); pass prefix_cache=False")
        if faults is not None:
            raise NotImplementedError(
                "fault injection is not ported yet (ROADMAP.md queue 1, "
                "item 5e: fault injection and quarantine)")
        if not device_resident or in_pool_prefill is False:
            raise NotImplementedError(
                "the device_resident=False / in_pool_prefill=False baselines "
                "are not ported yet (ROADMAP.md queue 1, item 5f)")
        self._torch, self._np = torch, np
        self.cfg = cfg
        self.params = params
        self.kv_dtype = kv_dtype
        self.kernel_backend = kernel_backend
        self._kv_dtype_arg = "int8" if kv_dtype == "int8" else None
        self.device_resident = True
        self.in_pool_prefill = True
        self.abortable_runs = abortable_runs
        self.decode_segment_steps = max(int(decode_segment_steps), 1)
        self.elastic_decode = bool(elastic_decode)
        self.max_len = max_len
        self.dtype = dtype or torch.float32
        w = params["embed"]["w"]
        self.device = torch.device(device) if device is not None \
            else w.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if w.device != self.device or w.dtype != self.dtype:
            raise ValueError(
                f"params are {w.dtype} on {w.device}; the backend runs "
                f"{self.dtype} on {self.device}")
        self.pool_slots_max = None if pool_slots_max is None \
            else max(int(pool_slots_max), 1)
        self.isolate_flow_faults = bool(isolate_flow_faults)
        self._pending_faults: List[FlowFault] = []
        self._quarantined: set = set()  # rids faulted, awaiting quarantine
        self.device_fault_retries = 0  # no fault injection yet
        self.flow_faults = 0
        self.quarantined_flows = 0
        self.pressure_evicted_nodes = 0
        self.pool_slots = max(int(pool_slots), 1)
        if self.pool_slots_max is not None:
            self.pool_slots = min(self.pool_slots, self.pool_slots_max)
        self._pool = self._new_pool(self.pool_slots)
        # min-heap: rebinding always takes the LOWEST free slot, so the live
        # high-water mark (and with it the elastic row bound) stays minimal
        self._free: List[int] = list(range(self.pool_slots))
        self._slot: Dict[int, int] = {}  # req id -> pool slot
        self._slot_pos: Dict[int, int] = {}  # pool slot -> live row position
        self._last: Dict[int, int] = {}  # host mirror of last emitted token
        self._texts: Dict[int, list] = {}
        self._on_token: Dict[int, TokenCallback] = {}
        # in-pool prefill state: device-resident prompt tokens (uploaded once
        # at register, pow-2 padded), per-request row progress, and the
        # not-yet-fetched first-token device scalar of a finished prefill
        self._tok_dev: Dict[int, object] = {}
        self._row_pos: Dict[int, Optional[int]] = {}
        self._nxt_dev: Dict[int, object] = {}
        # KV bytes one prompt token adds to a batch-1 cache, counted from
        # shapes on the meta device (no allocation)
        def _bytes(one_max_len):
            return cache_bytes(init_cache(cfg, params, 1, one_max_len,
                                          self.dtype,
                                          kv_dtype=self._kv_dtype_arg,
                                          device="meta"))
        self._kv_token_bytes = _bytes(1) - _bytes(0)
        self.quant_scale_bytes = sum(
            st[n].numel() * st[n].element_size()
            for st in self._pool["blocks"].values()
            for n in ("k_scale", "v_scale") if n in st)
        # device-resident batch state (DESIGN.md §6): last token per slot and
        # the current iteration's membership mask
        self._toks = torch.zeros((self.pool_slots,), dtype=torch.int32,
                                 device=self.device)
        self._mask = torch.zeros((self.pool_slots,), dtype=torch.bool,
                                 device=self.device)
        self._mask_host = np.zeros((self.pool_slots,), bool)  # mirror
        # fused-run replay buffer: host token block + committed membership;
        # _fused_left counts announced iterations NOT yet executed
        self._fused_rows: Deque = deque()
        self._fused_slots: Optional[frozenset] = None
        self._fused_left = 0
        self._shape_keys: set = set()
        self.jit_compilations = 0
        self.decode_device_calls = 0
        self.prefill_device_calls = 0
        self.host_syncs = 0  # device->host token fetches
        self.fused_steps = 0
        self.fused_runs = 0
        self.decode_segments = 0
        self.aborted_runs = 0
        self.aborted_steps = 0
        self.prefill_host_syncs = 0
        self.bind_device_calls = 0  # full-row bind scatters: 0 in-pool
        self.kv_bytes_prefill = 0
        self.decode_rows = 0
        self.decode_kv_limit = 0
        self.kv_bytes_decode = 0
        self.prefill_forward_tokens = 0
        # memory-contention observability (paper §6.4, DESIGN.md §14)
        self.prefill_bw_util = 0.35
        self.decode_bw_util = 0.85
        self._pressure_est = MemoryPressureEstimator()
        self._prefill_live: set = set()
        self.contention_pressure_peak = 0.0
        self.co_executed_segments = 0
        self._seg_solo_time = 0.0
        self._seg_solo_steps = 0
        self._seg_co_time = 0.0
        self._seg_co_steps = 0

    def _new_pool(self, slots: int):
        from repro_torch.models import init_cache
        return init_cache(self.cfg, self.params, slots, self.max_len,
                          self.dtype, kv_dtype=self._kv_dtype_arg,
                          device=self.device)

    def _shape_key(self, key: tuple) -> None:
        """Count a first-seen program shape (the reference's jit key)."""
        if key not in self._shape_keys:
            self._shape_keys.add(key)
            self.jit_compilations += 1

    # -- device programs --------------------------------------------------------
    def _prefill_chunk(self, sizes: tuple, buf, start: int, slot: int, *,
                       kv_limit: int, fresh: bool, emit: bool):
        """In-pool prefill of (up to two) pow-2 sub-chunks on a view of row
        ``slot`` bounded to the pow-2 ``kv_limit`` live prefix, slicing the
        tokens from the request's resident prompt buffer.  ``fresh``
        invalidates the previous occupant first; ``emit`` commits the first
        output token to the device token vector.  Returns the greedy next
        token as a device scalar (no host sync)."""
        from repro_torch.models import (extend, read_row, reset_row,
                                        truncate_rings, write_row_slice)
        self._shape_key(("prefill_chunk", self.pool_slots, sizes,
                         buf.shape[1], kv_limit, fresh, emit))
        pool = self._pool
        if fresh:
            reset_row(pool, slot)
        view = truncate_rings(read_row(pool, slot), kv_limit, self.max_len)
        off = 0
        for c in sizes:
            logits, view = extend(self.cfg, self.params, view,
                                  buf[:, start + off:start + off + c],
                                  kernel_backend=self.kernel_backend)
            off += c
        write_row_slice(pool, view, slot, start, off)
        nxt = logits.argmax(-1).to(self._torch.int32)[0]
        if emit:
            self._toks[slot] = nxt
        return nxt

    def _decode(self, n_steps: int, rows: int, kvl: int, fused: bool):
        """``n_steps`` masked decode iterations over the leading ``rows``
        pool rows and the ``kvl`` ring prefix, in place on the pool and the
        token vector.  Returns the (n_steps, rows) token block (fused) or
        the (rows,) next tokens, on the device."""
        from repro_torch.models import (decode_run, decode_step, slice_rows,
                                        write_rows_prefix)
        p = self.pool_slots
        self._shape_key(("decode_run", p, n_steps, rows, kvl) if fused
                        else ("decode", p, rows, kvl))
        sub = slice_rows(self._pool, rows) if rows < p else self._pool
        toks, mask = self._toks[:rows], self._mask[:rows]
        kw = dict(kv_limit=kvl, full_alloc=self.max_len,
                  kernel_backend=self.kernel_backend)
        if fused:
            out, t, sub = decode_run(self.cfg, self.params, sub, toks, mask,
                                     n_steps, **kw)
        else:
            out, _, sub = decode_step(self.cfg, self.params, sub, toks,
                                      mask, **kw)
            t = self._torch.where(mask, out, toks)
        if rows < p:
            write_rows_prefix(self._pool, sub, rows, kvl, self.max_len)
        toks.copy_(t)
        return out

    # -- slot management -----------------------------------------------------
    def _grow_pool(self):
        """Double the pool up to ``pool_slots_max`` (DESIGN.md §12); at the
        cap, growth is a typed ``AllocationFault``."""
        from repro_torch.models import copy_into_prefix
        torch, np = self._torch, self._np
        old, p = self._pool, self.pool_slots
        target = p * 2 if self.pool_slots_max is None \
            else min(p * 2, self.pool_slots_max)
        if target <= p:
            raise AllocationFault(
                f"KV pool exhausted at pool_slots_max={self.pool_slots_max} "
                f"({p} slots bound, 0 free) and may not grow")
        self.pool_slots = target
        grown = target - p
        self._pool = copy_into_prefix(self._new_pool(target), old, p)
        for s in range(p, self.pool_slots):
            heapq.heappush(self._free, s)
        self._toks = torch.cat([self._toks, torch.zeros(
            (grown,), dtype=torch.int32, device=self.device)])
        self._mask = torch.cat([self._mask, torch.zeros(
            (grown,), dtype=torch.bool, device=self.device)])
        self._mask_host = np.concatenate(
            [self._mask_host, np.zeros((grown,), bool)])

    def _alloc_slot(self, rid: int) -> int:
        """Bind the LOWEST free slot (min-heap), growing the pool if none is
        free; raises ``AllocationFault`` at ``pool_slots_max``."""
        if not self._free:
            self._grow_pool()
        slot = heapq.heappop(self._free)
        self._slot[rid] = slot
        return slot

    def _sync_mask(self, slots: List[int]):
        """Push the iteration's membership to the device mask when it
        changed (one small host-to-device copy, no device-to-host sync)."""
        np = self._np
        want = np.zeros((self.pool_slots,), bool)
        want[slots] = True
        diff = np.nonzero(want != self._mask_host)[0]
        if len(diff) == 0:
            return
        self._shape_key(("mask", self.pool_slots, _next_pow2(len(diff))))
        self._mask.copy_(self._torch.from_numpy(want))
        self._mask_host = want

    # -- in-pool prefill (DESIGN.md §7) ---------------------------------------
    def _upload_prompt(self, req: Request):
        """Device-resident prompt tokens, uploaded ONCE per request and
        padded to the next power of two."""
        rid = req.id
        buf = self._tok_dev.get(rid)
        if buf is None:
            np = self._np
            toks = np.asarray(req.tokens, np.int32).reshape(1, -1)
            pad = np.zeros((1, _next_pow2(max(toks.shape[1], 1))), np.int32)
            pad[:, :toks.shape[1]] = toks
            buf = self._tok_dev[rid] = self._torch.from_numpy(pad).to(
                self.device)
        return buf

    def _ensure_row_at(self, req: Request, seq_start: int):
        """Pool row positioned at ``seq_start``: the slot is allocated at
        prefill START and its reused row invalidated by the next chunk's
        ``fresh`` program; a discard-style preemption that reset the
        scheduler's chunk progress re-invalidates the row and replays the
        already-prefilled prefix."""
        rid = req.id
        if rid in self._slot and self._row_pos.get(rid) == seq_start:
            return
        if rid not in self._slot:
            self._alloc_slot(rid)
        self._row_pos[rid] = None  # sentinel: next bucket resets the row
        self._nxt_dev.pop(rid, None)
        if seq_start > 0:
            self._run_bucketed_in_pool(req, 0, seq_start)

    def _run_bucketed_in_pool(self, req: Request, start: int, n: int):
        if n <= 0:  # zero-length chunk: nothing ran, nothing to dispatch
            return
        rid = req.id
        buf = self._upload_prompt(req)
        buckets = _pow2_buckets(n)
        # buckets in pairs: one device program per group, bounded key space
        groups = [tuple(buckets[i:i + 2]) for i in range(0, len(buckets), 2)]
        fresh = self._row_pos.get(rid) is None
        pos = start
        for sizes in groups:
            gstart, pos = pos, pos + sum(sizes)
            nxt = self._prefill_chunk(sizes, buf, gstart, self._slot[rid],
                                      kv_limit=_next_pow2(pos), fresh=fresh,
                                      emit=pos >= req.prompt_len)
            self.prefill_device_calls += 1
            fresh = False
        self._row_pos[rid] = pos
        self.kv_bytes_prefill += n * self._kv_token_bytes
        self.prefill_forward_tokens += n
        if pos >= req.prompt_len:
            # keep the first output token on device: ONE host sync per
            # request happens at prefill_done, not per chunk
            self._nxt_dev[rid] = nxt

    def register(self, req: Request,
                 on_token: Optional[TokenCallback] = None) -> None:
        if on_token is not None:
            self._on_token[req.id] = on_token
        if req.tokens is not None:
            self._upload_prompt(req)

    # -- per-flow fault isolation (DESIGN.md §12) -----------------------------
    def _record_flow_fault(self, req: Request, exc: BaseException,
                           stage: str) -> None:
        """Park a flow-attributable failure for the scheduler's per-turn
        poll; ``isolate_flow_faults=False`` raises it instead."""
        self.flow_faults += 1
        if not self.isolate_flow_faults:
            raise exc
        self._quarantined.add(req.id)
        self._pending_faults.append(FlowFault(req, exc, stage))

    def take_flow_faults(self) -> List[FlowFault]:
        out, self._pending_faults = self._pending_faults, []
        return out

    def _track_prefill(self, rid: int) -> None:
        if rid not in self._prefill_live:
            self._prefill_live.add(rid)
            self._pressure_est.add(f"prefill:{rid}", self.prefill_bw_util)
            self.contention_pressure_peak = max(
                self.contention_pressure_peak, self._pressure_est.pressure)

    def _untrack_prefill(self, rid: int) -> None:
        if rid in self._prefill_live:
            self._prefill_live.discard(rid)
            self._pressure_est.remove(f"prefill:{rid}")

    def prefill_chunk(self, req: Request, seq_start: int, tokens: int,
                      now: float) -> None:
        if req.tokens is None or req.id in self._quarantined:
            return
        self._track_prefill(req.id)
        try:
            self._ensure_row_at(req, seq_start)
            self._run_bucketed_in_pool(req, seq_start, tokens)
        except FaultError as e:
            self._record_flow_fault(req, e, "prefill")

    def prefill_done(self, req: Request, now: float) -> None:
        if req.id in self._quarantined:
            return
        self._untrack_prefill(req.id)
        rid = req.id
        if req.tokens is None or rid not in self._slot:
            return
        nxt = self._nxt_dev.pop(rid, None)
        if nxt is None:
            # prefill made entirely of zero-length chunks: no program ran
            # and there is no token to decode on; return the slot
            heapq.heappush(self._free, self._slot.pop(rid))
            self._row_pos.pop(rid, None)
            return
        first = int(nxt)  # the one host sync of this prefill
        self.host_syncs += 1
        self.prefill_host_syncs += 1
        self._row_pos.pop(rid, None)
        # host-known row progress: decode dispatches derive their pow-2
        # kv_limit from the max live position of the batch (§9)
        self._slot_pos[self._slot[rid]] = req.prompt_len
        self._last[rid] = first
        self._texts[rid] = [first]
        self._emit(req, first)

    # -- decode ---------------------------------------------------------------
    def decode_run(self, reqs: List[Request], n_steps: int,
                   now: float) -> None:
        """Commit to a membership-stable run.  Abortable mode (default)
        launches only the first segment now and the rest lazily as the
        replay buffer drains, so a reactive arrival between segments cancels
        the unlaunched remainder (``request_preempt``)."""
        live = [r for r in reqs if r.id in self._slot
                and r.id not in self._quarantined]
        if not live or n_steps <= 1:
            return
        slots = [self._slot[r.id] for r in live]
        self._sync_mask(slots)
        self._fused_rows = deque()
        self._fused_slots = frozenset(slots)
        self._fused_left = int(n_steps)
        self.fused_runs += 1
        self._run_segment()

    def _elastic_extent(self, slots: List[int], n: int) -> tuple:
        """``(rows, kv_limit)`` of a decode dispatch of ``n`` iterations:
        ``rows = next_pow2(high-water live slot + 1)`` and ``kv_limit =
        next_pow2(max live position + n)``.  A row of unknown progress
        pushes ``kv_limit`` to ``max_len``, and so does a wrapped ring
        (its position is past ``max_len``): truncation then is the
        identity.  Window-shrunk leaves are never truncated
        (``kvcache.truncate_rings``)."""
        if not self.elastic_decode:
            return self.pool_slots, self.max_len
        rows = min(_next_pow2(max(slots) + 1), self.pool_slots)
        pos = [self._slot_pos.get(s) for s in slots]
        if any(p is None for p in pos):
            return rows, self.max_len
        return rows, min(_next_pow2(max(pos) + n), self.max_len)

    def _account_decode(self, slots: List[int], n: int, rows: int, kvl: int):
        for s in slots:
            if s in self._slot_pos:
                self._slot_pos[s] += n
        self.decode_rows, self.decode_kv_limit = rows, kvl
        self.kv_bytes_decode += n * rows * kvl * self._kv_token_bytes

    def _run_segment(self) -> None:
        """Launch the next bounded segment of the committed run and fetch
        its token block (ONE host sync per segment)."""
        n = min(self._fused_left, self.decode_segment_steps) \
            if self.abortable_runs else self._fused_left
        if n <= 0:
            return
        slots = sorted(self._fused_slots)
        co_executed = bool(self._prefill_live)
        self._pressure_est.add("decode", self.decode_bw_util)
        self.contention_pressure_peak = max(
            self.contention_pressure_peak, self._pressure_est.pressure)
        t0 = time.perf_counter()
        blocks = []
        for b in _pow2_buckets(n):
            rows, kvl = self._elastic_extent(slots, b)
            block = self._decode(b, rows, kvl, fused=True)
            self.decode_device_calls += 1
            self._account_decode(slots, b, rows, kvl)
            blocks.append(block)
        full = self._torch.cat(blocks).cpu().numpy()  # the one host sync
        seg_wall = time.perf_counter() - t0
        self._pressure_est.remove("decode")
        if co_executed:
            self.co_executed_segments += 1
            self._seg_co_time += seg_wall
            self._seg_co_steps += n
        else:
            self._seg_solo_time += seg_wall
            self._seg_solo_steps += n
        self.host_syncs += 1
        self._fused_rows.extend(full)
        self._fused_left -= n
        self.fused_steps += n
        self.decode_segments += 1

    def request_preempt(self, now: float) -> None:
        """Cancel every segment of the committed run not launched yet;
        buffered rows stay for the scheduler's replay."""
        if self._fused_left > 0:
            self.aborted_runs += 1
            self.aborted_steps += self._fused_left
            self._fused_left = 0
            if not self._fused_rows:
                self._fused_slots = None

    def decode_iteration(self, reqs: List[Request], now: float) -> None:
        live = [r for r in reqs if r.id in self._slot
                and r.id not in self._quarantined]
        if not live:
            return
        if self._fused_rows or (self._fused_slots is not None
                                and self._fused_left > 0):
            if not self._fused_rows:
                self._run_segment()  # lazy: next segment only when needed
            self._replay_row(live)
            return
        slots = [self._slot[r.id] for r in live]
        self._sync_mask(slots)
        rows, kvl = self._elastic_extent(slots, 1)
        nxt = self._decode(1, rows, kvl, fused=False)
        self.decode_device_calls += 1
        self._account_decode(slots, 1, rows, kvl)
        nxt = nxt.cpu().numpy()  # the one host sync of this iteration
        self.host_syncs += 1
        self._commit(live, nxt)

    def _replay_row(self, live: List[Request]):
        """One committed iteration of an already executed fused run: tokens
        come from the buffered block, with no device call or host sync."""
        slots = frozenset(self._slot[r.id] for r in live)
        if slots != self._fused_slots:
            raise RuntimeError(
                "decode batch membership diverged from the announced fused "
                f"run (planned slots {sorted(self._fused_slots)}, got "
                f"{sorted(slots)}) — the scheduler's event horizon must be "
                "a guaranteed lower bound")
        row = self._fused_rows.popleft()
        if not self._fused_rows and self._fused_left <= 0:
            self._fused_slots = None  # plan fully executed AND replayed
        self._commit(live, row)

    def _commit(self, live: List[Request], tokens_by_slot):
        for r in live:
            t = int(tokens_by_slot[self._slot[r.id]])
            self._last[r.id] = t
            self._texts[r.id].append(t)
            self._emit(r, t)

    def _drop_flow_state(self, rid: int) -> None:
        """Free one flow's slot and host bookkeeping (``finish`` and
        ``quarantine_flow``).  ``_texts`` survives: ``output_tokens()``
        outlives the run."""
        slot = self._slot.pop(rid, None)
        if slot is not None:
            # clear the slot's last token and mask bit so a stale token can
            # never leak into a future bind's first masked step
            self._shape_key(("clear", self.pool_slots))
            self._toks[slot] = 0
            self._mask[slot] = False
            self._mask_host[slot] = False
            self._slot_pos.pop(slot, None)
            heapq.heappush(self._free, slot)
        self._untrack_prefill(rid)
        self._last.pop(rid, None)
        self._on_token.pop(rid, None)
        self._tok_dev.pop(rid, None)
        self._row_pos.pop(rid, None)
        self._nxt_dev.pop(rid, None)

    def finish(self, req: Request, now: float) -> None:
        slot = self._slot.get(req.id)
        if slot is not None and self._fused_slots is not None \
                and slot in self._fused_slots:
            # a planned member vanished mid-run (release cut-off): the
            # remaining buffered rows and unlaunched segments are stale
            self._fused_rows.clear()
            self._fused_slots = None
            self._fused_left = 0
        self._quarantined.discard(req.id)
        self._drop_flow_state(req.id)

    def quarantine_flow(self, req: Request, now: float) -> None:
        """Retire ONE failed, expired or cancelled flow (DESIGN.md §12):
        cancel only the unlaunched segments and drop its slot from the
        committed membership, keeping every survivor's buffered rows."""
        rid = req.id
        self._quarantined.discard(rid)
        self._pending_faults = [f for f in self._pending_faults
                                if f.req_id != rid]
        slot = self._slot.get(rid)
        if slot is not None and self._fused_slots is not None \
                and slot in self._fused_slots:
            if self._fused_left > 0:
                self.aborted_runs += 1
                self.aborted_steps += self._fused_left
                self._fused_left = 0
            rest = self._fused_slots - {slot}
            if rest and self._fused_rows:
                self._fused_slots = rest  # survivors replay token-exactly
            else:
                self._fused_rows.clear()
                self._fused_slots = None
        self._drop_flow_state(rid)
        self.quarantined_flows += 1

    def release(self, reqs: List[Request], now: float) -> None:
        """Free resources of requests cut off mid-flight."""
        dropped = {r.id for r in reqs}
        self._pending_faults = [f for f in self._pending_faults
                                if f.req_id not in dropped]
        for r in reqs:
            self.finish(r, now)
        self._fused_rows.clear()  # uncommitted fused tokens are dropped
        self._fused_slots = None
        self._fused_left = 0

    # -- output ----------------------------------------------------------------
    def _emit(self, req: Request, token: int):
        """Per-token user-hook boundary: an exception from ONE flow's
        callback is parked as a ``FlowFault`` (the flow is quarantined as
        ``failed``) while every other flow keeps streaming."""
        if req.id in self._quarantined:
            return
        cb = self._on_token.get(req.id)
        try:
            if cb is not None:
                cb(req, token)
        except Exception as e:
            self._record_flow_fault(req, e, "hook")

    def output_tokens(self, req_id: int) -> list:
        return self._texts.get(req_id, [])

    def validate(self, strict: bool = False) -> List[str]:
        """Slot-accounting invariants (DESIGN.md §12): the free heap and the
        bound slots partition the pool, and per-slot state exists only for
        bound slots.  Host work only, no device sync."""
        problems: List[str] = []
        free = list(self._free)
        bound = dict(self._slot)
        if len(set(free)) != len(free):
            problems.append(f"free heap has duplicates: {sorted(free)}")
        if any(s < 0 or s >= self.pool_slots for s in free):
            problems.append(f"free heap out of range: {sorted(free)}")
        overlap = set(free) & set(bound.values())
        if overlap:
            problems.append(f"slots both free and bound: {sorted(overlap)}")
        if len(free) + len(bound) != self.pool_slots:
            problems.append(
                f"slot leak: {len(free)} free + {len(bound)} bound "
                f"!= {self.pool_slots} pool slots")
        stale_pos = set(self._slot_pos) - set(bound.values())
        if stale_pos:
            problems.append(f"_slot_pos for unbound slots: "
                            f"{sorted(stale_pos)}")
        stale_mask = [s for s in range(self.pool_slots)
                      if self._mask_host[s] and s not in bound.values()]
        if stale_mask:
            problems.append(f"mask set for unbound slots: {stale_mask}")
        if self._fused_slots is not None:
            ghost = set(self._fused_slots) - set(bound.values())
            if ghost:
                problems.append(f"fused plan over unbound slots: "
                                f"{sorted(ghost)}")
        if strict and problems:
            raise InvariantViolation("; ".join(problems))
        return problems

    def stats(self) -> dict:
        """The reference's keys; the prefix-cache ones stay 0 (no prefix
        cache yet)."""
        return {"jit_compilations": self.jit_compilations,
                "decode_device_calls": self.decode_device_calls,
                "prefill_device_calls": self.prefill_device_calls,
                "host_syncs": self.host_syncs,
                "fused_steps": self.fused_steps,
                "fused_runs": self.fused_runs,
                "decode_segments": self.decode_segments,
                "aborted_runs": self.aborted_runs,
                "aborted_steps": self.aborted_steps,
                "prefill_host_syncs": self.prefill_host_syncs,
                "bind_device_calls": self.bind_device_calls,
                "kv_bytes_prefill": self.kv_bytes_prefill,
                "decode_rows": self.decode_rows,
                "decode_kv_limit": self.decode_kv_limit,
                "kv_bytes_decode": self.kv_bytes_decode,
                "pool_slots": self.pool_slots,
                "pool_slots_max": self.pool_slots_max,
                "free_slots": len(self._free),
                "device_fault_retries": self.device_fault_retries,
                "flow_faults": self.flow_faults,
                "quarantined_flows": self.quarantined_flows,
                "pressure_evicted_nodes": self.pressure_evicted_nodes,
                "kv_dtype": self.kv_dtype,
                "kernel_backend": self.kernel_backend,
                "quant_scale_bytes": self.quant_scale_bytes,
                "prefix_hits": 0,
                "prefix_hit_tokens": 0,
                "prefix_hit_rate": 0.0,
                "kv_bytes_prefix_copied": 0,
                "prefix_copy_device_calls": 0,
                "prefix_promotions": 0,
                "prefix_fallbacks": 0,
                "prefix_store_entries": 0,
                "prefill_forward_tokens": self.prefill_forward_tokens,
                **self._contention_stats()}

    def _contention_stats(self) -> dict:
        """Memory-contention observability (paper §6.4, DESIGN.md §14)."""
        solo = self._seg_solo_time / self._seg_solo_steps \
            if self._seg_solo_steps else None
        co = self._seg_co_time / self._seg_co_steps \
            if self._seg_co_steps else None
        measured = (co / solo) if (solo and co) else None
        model_rates = co_execution_rates(
            [self.prefill_bw_util, self.decode_bw_util])
        return {
            "prefill_bw_util": self.prefill_bw_util,
            "decode_bw_util": self.decode_bw_util,
            "contention_pressure": self._pressure_est.pressure,
            "contention_pressure_peak": self.contention_pressure_peak,
            "co_executed_segments": self.co_executed_segments,
            "co_execution_rate": self.co_executed_segments
            / max(self.decode_segments, 1),
            "co_execution_decode_slowdown_measured": measured,
            "co_execution_decode_slowdown_model":
                1.0 / max(model_rates[1], 1e-9),
            "co_execution_prefill_slowdown_model":
                1.0 / max(model_rates[0], 1e-9),
        }
