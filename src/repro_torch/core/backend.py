"""Pluggable execution backends (DESIGN.md §2, §6), PyTorch port.

The scheduler is execution-agnostic: it announces *kernel completions* in
simulated-clock order and an ``ExecutionBackend`` decides what (if anything)
actually runs.  Two implementations:

  SimBackend        pure timing study — every hook is a no-op; this module
                    imports no torch at module level, so the simulation-only
                    path stays free of it.
  TorchRealBackend  real token generation on a device-resident slot-pool KV
                    cache (the port of the reference's ``JaxRealBackend``).
  DualDeviceBackend stage-decoupled execution: prefill on a second lane (a
                    second GPU, or a second stream of the same GPU), KV
                    handed off into the decode pool (``DualDeviceBackend``
                    of the reference).

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
                                     InvariantViolation,
                                     PermanentDeviceFault,
                                     TransientDeviceFault)
from repro_torch.core.prefixcache import (PrefixCache,
                                          prefix_reuse_supported)
from repro_torch.core.requests import Request
from repro_torch.core.tracing import Tracer

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

    * a matched shared prefix (DESIGN.md §10) is served by one bounded
      row-to-row KV copy (``kvcache.copy_prefix_rows``), or from the
      refcounted snapshot store once its donor row was rebound
      (``snapshot_prefix`` / ``paste_prefix``); configs that fail
      ``prefix_reuse_supported`` silently serve cold, as in the reference;
    * every device program goes through :meth:`_call`, the fault seam
      (DESIGN.md §12): it counts the program's shape key and consults the
      ``FaultInjector`` BEFORE the launch, so a fault never leaves a
      half-written row behind.

    PyTorch runs eagerly, so nothing is compiled; ``jit_compilations``
    counts the first-seen shape keys the reference would have compiled, and
    ``decode_device_calls``/``host_syncs`` count as in the reference.

    ``kernel_backend`` picks each layer's route by its config, not at run
    time.  MLA configs (deepseek-v2) take ``"cuda"`` too: their attention
    runs the plain MLA functions of ``models.attention`` under either
    backend (the reference's XLA path, its only one for MLA; its refusal of
    ``"pallas"`` for MLA is about its attention kernels, which the port's
    ``"plain"`` mode already skips), and their expert products run
    ``moe_gemm``.  An int8 pool is refused for MLA, as the reference
    refuses it (``kv_supports_int8``).

    The reference's two measurable baselines:

    * ``in_pool_prefill=False``: each prompt prefills into a B=1 scratch
      cache (per-chunk host token uploads, one host sync at the last chunk)
      that ``prefill_done`` binds into a freshly allocated row with one
      full-row scatter (``kvcache.write_slot``): the double KV write;
    * ``device_resident=False``: the pre-donation hot path.  No fused runs,
      full-pool decode, the batch's tokens and mask rebuilt on the host and
      uploaded every iteration, and scratch prefill by default.  Where the
      reference's un-donated programs wrote fresh output buffers, each
      program here writes a fresh copy of the pool (and token state) it
      would otherwise update in place (``kvcache.copy_cache``), so the
      baseline pays the copy the reference's pays.
    """

    name = "torch"

    _ENC_DEC_MSG = (
        "TorchRealBackend cannot serve encoder-decoder configs: slot "
        "rebinding invalidates a pool row with kvcache.reset_row, which "
        "deliberately leaves enc_out / cross-attention state untouched — a "
        "rebound slot would silently serve the PREVIOUS occupant's encoder "
        "output as its cross-attention context")

    def __init__(self, cfg, params, *, pool_slots: int, max_len: int = 512,
                 dtype=None, device=None, device_resident: bool = True,
                 in_pool_prefill: Optional[bool] = None,
                 abortable_runs: bool = True,
                 decode_segment_steps: int = 8,
                 elastic_decode: bool = True,
                 prefix_cache: bool = True,
                 prefix_cache_tokens: Optional[int] = None,
                 prefix_block: int = 1,
                 kv_dtype: str = "bf16",
                 kernel_backend: str = "cuda",
                 pool_slots_max: Optional[int] = None,
                 isolate_flow_faults: bool = True,
                 faults: Optional[FaultInjector] = None,
                 device_fault_retries_max: int = 3):
        import numpy as np
        import torch
        from repro_torch.models import cache_bytes, check_supported, \
            init_cache, kv_supports_int8
        from repro_torch.models.transformer import KERNEL_BACKENDS
        # the reference's refusals, in its order: the model API runs these
        # forms, the serving path does not
        if cfg.is_encoder_decoder:
            raise NotImplementedError(self._ENC_DEC_MSG)
        if cfg.frontend != "none":
            raise NotImplementedError(
                "TorchRealBackend serves text-only decoders")
        check_supported(cfg)
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8': {kv_dtype}")
        if kv_dtype == "int8" and not kv_supports_int8(cfg):
            raise NotImplementedError(
                "int8 KV quantization needs the per-(slot, kv head) k/v ring "
                "layout; MLA configs cache a headless latent")
        if kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(f"kernel_backend must be one of "
                             f"{KERNEL_BACKENDS}: {kernel_backend!r}")
        self._torch, self._np = torch, np
        self.cfg = cfg
        self.params = params
        self.kv_dtype = kv_dtype
        self.kernel_backend = kernel_backend
        self._kv_dtype_arg = "int8" if kv_dtype == "int8" else None
        # device_resident=False: the pre-donation baseline (see above);
        # in_pool_prefill follows it by default, as in the reference
        self.device_resident = bool(device_resident)
        self.in_pool_prefill = self.device_resident \
            if in_pool_prefill is None else bool(in_pool_prefill)
        self.abortable_runs = abortable_runs
        self.decode_segment_steps = max(int(decode_segment_steps), 1)
        # the legacy baseline decodes over the full pool too
        self.elastic_decode = bool(elastic_decode) and self.device_resident
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
        self._faults = faults
        self._fault_retry_max = max(int(device_fault_retries_max), 0)
        self._pending_faults: List[FlowFault] = []
        self._quarantined: set = set()  # rids faulted, awaiting quarantine
        self.device_fault_retries = 0  # transient launch failures retried
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
        # scratch-cache prefill (in_pool_prefill=False), and the staging
        # caches of DualDeviceBackend: req id -> B=1 cache and its position
        self._scratch: Dict[int, object] = {}
        self._scratch_pos: Dict[int, int] = {}
        self._first: Dict[int, int] = {}  # first token (from last chunk)
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
        self._bind_row_bytes = _bytes(max_len)  # one full-row bind scatter
        pool = self._pool
        self.quant_scale_bytes = sum(
            st[n].numel() * st[n].element_size()
            for st in (*pool["head"], *pool["blocks"].values(), *pool["tail"])
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
        # shared-prefix KV reuse (DESIGN.md §10): a host-side radix index
        # over prompt token IDs; a hit replaces the matched prefix's forward
        # passes with ONE bounded row-to-row KV copy
        from repro_torch.core.prefixcache import DEFAULT_CAPACITY_TOKENS
        # (the copy is an in-pool row write: the baselines serve cold)
        self._prefix: Optional[PrefixCache] = None
        if prefix_cache and self.in_pool_prefill and self.device_resident \
                and prefix_reuse_supported(cfg, max_len):
            self._prefix = PrefixCache(
                prefix_cache_tokens or DEFAULT_CAPACITY_TOKENS,
                block=prefix_block)
        self._hit: Dict[int, int] = {}  # req id -> matched prefix length
        self._hit_node: Dict[int, object] = {}  # req id -> pinned radix node
        # physical prefix sources: nodes backed by a live/free pool row
        # (slot -> node set), and the refcounted off-pool snapshot store for
        # prefixes whose donor slot was rebound (entry id -> entry)
        self._slot_nodes: Dict[int, set] = {}
        self._store: Dict[int, dict] = {}
        self._store_next = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0
        self.prefix_copy_device_calls = 0  # row/store -> row prefix copies
        self.prefix_promotions = 0  # donor-slot rebinds snapshotted to store
        self.prefix_fallbacks = 0  # hits served by forward passes (no source)
        self.kv_bytes_prefix_copied = 0  # KV bytes moved by prefix copies
        self.prefill_forward_tokens = 0  # tokens that ran a real forward
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
        # in-program spans (core.tracing); the engine hands in its own
        self.tracer = Tracer()

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

    def _call(self, key: tuple, fn, *args, rid: Optional[int] = None,
              stage: str = "device", **kw):
        """Launch one device program through the fault seam (DESIGN.md
        §12): count its shape ``key``, then consult the injector BEFORE the
        launch.  The port writes the pool in place, so a check after a
        partial write would leave a half-advanced row; checked first, a
        retry is a clean re-launch.  Transient faults are retried up to
        ``device_fault_retries_max`` times, then escalate to
        ``PermanentDeviceFault``; flow-attributable sites pass ``rid``."""
        self._shape_key(key)
        if self._faults is not None:
            for _ in range(self._fault_retry_max + 1):
                try:
                    self._faults.check("device", req_id=rid, stage=stage)
                    break
                except TransientDeviceFault:
                    self.device_fault_retries += 1
            else:
                raise PermanentDeviceFault(
                    f"transient device fault at {stage} persisted past "
                    f"{self._fault_retry_max} segment replays")
        tr = self.tracer
        if not tr.on:
            return fn(*args, **kw)
        with tr.span("backend.launch", rid):  # the host's eager enqueue
            return fn(*args, **kw)

    def _to_host(self, t, rid: Optional[int] = None):
        """Fetch ``t`` to the host as a numpy array: a device-to-host sync
        (a ``backend.sync`` span when tracing)."""
        tr = self.tracer
        if not tr.on:
            return t.cpu().numpy()
        with tr.span("backend.sync", rid):
            return t.cpu().numpy()

    # -- device programs (launched through _call) -----------------------------
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

    def _decode(self, n_steps: int, rows: int, kvl: int, fused: bool,
                batch=None):
        """``n_steps`` masked decode iterations over the leading ``rows``
        pool rows and the ``kvl`` ring prefix, in place on the pool and the
        token vector.  Returns the (n_steps, rows) token block (fused) or
        the (rows,) next tokens, on the device.  ``batch``: the legacy
        baseline's uploaded (tokens, mask), decoded on a fresh copy of the
        pool into a fresh token vector (the un-donated program)."""
        from repro_torch.models import (copy_cache, decode_run, decode_step,
                                        slice_rows, write_rows_prefix)
        p = self.pool_slots
        if batch is not None:
            self._pool = copy_cache(self._pool)
            self._toks = batch[0]
        sub = slice_rows(self._pool, rows) if rows < p else self._pool
        toks = self._toks[:rows]
        mask = (self._mask if batch is None else batch[1])[:rows]
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

    def _decode_call(self, n_steps: int, rows: int, kvl: int, fused: bool,
                     batch=None):
        key = ("decode_run", self.pool_slots, n_steps, rows, kvl) if fused \
            else ("decode", self.pool_slots, rows, kvl)
        return self._call(key, self._decode, n_steps, rows, kvl, fused,
                          batch, stage="decode")

    def _clear_slot(self, slot: int) -> None:
        """Clear a freed slot's last token and mask bit, so a stale token
        can never leak into a future bind's first masked step (fills on the
        device: no host-to-device copy; on fresh copies in the legacy
        baseline)."""
        if not self.device_resident:
            self._toks, self._mask = self._toks.clone(), self._mask.clone()
        self._toks.narrow(0, slot, 1).zero_()
        self._mask.narrow(0, slot, 1).zero_()

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
        free.  If the popped row still backs radix prefixes, they are
        promoted to the store FIRST: the row is about to be reused
        (DESIGN.md §10).  Raises ``AllocationFault`` (injected, or real at
        ``pool_slots_max``)."""
        if self._faults is not None:
            self._faults.check("alloc", req_id=rid)
        if not self._free:
            self._grow_pool()
        slot = heapq.heappop(self._free)
        self._promote_donor(slot)
        self._slot[rid] = slot
        return slot

    # -- shared-prefix sources (DESIGN.md §10) --------------------------------
    def _set_source(self, node, src) -> None:
        """Re-point a radix node's physical KV source, keeping the reverse
        maps (slot -> nodes, store refcounts) consistent.  A store entry
        whose last referencing node departs is freed."""
        old = node.source
        if old == src:
            return
        if old is not None:
            kind, ref = old
            if kind == "slot":
                nodes = self._slot_nodes.get(ref)
                if nodes is not None:
                    nodes.discard(node)
                    if not nodes:
                        del self._slot_nodes[ref]
            else:
                entry = self._store.get(ref)
                if entry is not None:
                    entry["refs"] -= 1
                    if entry["refs"] <= 0:
                        del self._store[ref]
        node.source = src
        if src is not None:
            kind, ref = src
            if kind == "slot":
                self._slot_nodes.setdefault(ref, set()).add(node)
            else:
                self._store[ref]["refs"] += 1

    def _promote_donor(self, slot: int) -> None:
        """A free slot that still backs indexed prefixes is being rebound:
        snapshot the deepest donated prefix into a refcounted store entry
        (one bounded copy) and re-point every backed node at it.  Promotion
        never drops an indexed prefix, so the index stays a pure function of
        the insert/evict sequence (sim and real traces stay equal)."""
        from repro_torch.models import snapshot_prefix
        nodes = self._slot_nodes.get(slot)
        if not nodes:
            return
        depth_cap = _next_pow2(max(n.depth for n in nodes))
        entry_cache = self._call(
            ("prefix_snap", self.pool_slots, depth_cap), snapshot_prefix,
            self._pool, slot, depth_cap, self.max_len, stage="prefix_copy")
        eid = self._store_next
        self._store_next += 1
        self._store[eid] = {"cache": entry_cache, "cap": depth_cap,
                            "refs": 0}
        self.prefix_promotions += 1
        for n in list(nodes):
            self._set_source(n, ("store", eid))

    def _sync_mask(self, slots: List[int]):
        """Push the iteration's membership to the device mask when it
        changed (one small host-to-device copy, no device-to-host sync)."""
        np = self._np
        want = np.zeros((self.pool_slots,), bool)
        want[slots] = True
        diff = np.nonzero(want != self._mask_host)[0]
        if len(diff) == 0:
            return
        self._call(("mask", self.pool_slots, _next_pow2(len(diff))),
                   self._mask.copy_, self._torch.from_numpy(want),
                   stage="mask")
        self._mask_host = want

    # -- scratch-cache prefill (in_pool_prefill=False) ------------------------
    def _ensure_scratch_at(self, req: Request, seq_start: int):
        """Scratch cache positioned at ``seq_start``: rebuilt (replaying the
        already-prefilled prefix) after a discard-style preemption reset the
        scheduler's chunk progress."""
        rid = req.id
        if rid in self._scratch and self._scratch_pos[rid] == seq_start:
            return
        self._scratch[rid] = self._new_pool(1)
        self._scratch_pos[rid] = 0
        if seq_start > 0:
            self._run_bucketed(req, 0, seq_start)

    def _scratch_extend(self, cache, chunk):
        """One pow-2 bucket against a B=1 cache (in place; on a fresh copy
        in the legacy baseline).  Returns (greedy next token as a device
        scalar, the cache)."""
        from repro_torch.models import copy_cache, extend
        if not self.device_resident:
            cache = copy_cache(cache)
        logits, cache = extend(self.cfg, self.params, cache, chunk,
                               kernel_backend=self.kernel_backend)
        return logits.argmax(-1).to(self._torch.int32)[0], cache

    def _run_bucketed(self, req: Request, start: int, n: int):
        if n <= 0:  # zero-length chunk: nothing ran, ``nxt`` never exists
            return
        rid = req.id
        np, pos = self._np, start
        for size in _pow2_buckets(n):
            # the baseline's per-chunk host upload
            chunk = self._torch.from_numpy(np.asarray(
                req.tokens[:, pos:pos + size], np.int32)).to(self.device)
            nxt, self._scratch[rid] = self._call(
                ("extend", size), self._scratch_extend, self._scratch[rid],
                chunk, rid=rid, stage="prefill")
            self.prefill_device_calls += 1
            pos += size
        self._scratch_pos[rid] = pos
        self.kv_bytes_prefill += n * self._kv_token_bytes
        self.prefill_forward_tokens += n
        if pos >= req.prompt_len:  # last chunk -> first output token
            self._first[rid] = int(nxt)
            self._nxt_dev[rid] = nxt  # for the bind, device to device
            self.host_syncs += 1
            self.prefill_host_syncs += 1

    def _bind(self, one, slot: int, first_dev) -> None:
        """The scratch baseline's bind: ``one`` scattered whole into pool row
        ``slot`` and the first token into the token vector, device to
        device (fresh copies of both in the legacy baseline)."""
        from repro_torch.models import copy_cache, write_slot
        if not self.device_resident:
            self._pool = copy_cache(self._pool)
            self._toks = self._toks.clone()
        write_slot(self._pool, one, slot)
        self._toks.narrow(0, slot, 1).copy_(first_dev.reshape(1))

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

    def prefix_hit(self, req: Request) -> int:
        """Scheduler hook (arrival time): longest indexed prefix of the
        prompt, matched on exact token IDs and pinned until the request
        retires; served by ONE KV copy at the first prefill chunk
        (``_copy_prefix``).  Capped at ``prompt_len - 1``: at least one
        forward must run to produce the first output token."""
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
        self._hit[req.id] = hit
        self._hit_node[req.id] = node
        self.prefix_hits += 1
        self.prefix_hit_tokens += hit
        return hit

    def _copy_prefix(self, req: Request, hit: int) -> int:
        """Serve a matched prefix into the request's freshly bound row as
        one bounded KV copy, resolving the pinned node's physical source AT
        COPY TIME (the donor may have been promoted slot -> store since the
        match).  Returns the row position reached; 0 means no resolvable
        source (the caller then runs forward passes: a hit can slow down but
        never change tokens)."""
        from repro_torch.models import copy_prefix_rows, paste_prefix
        node = self._hit_node.get(req.id)
        src = getattr(node, "source", None)
        if src is None:
            self.prefix_fallbacks += 1
            return 0
        dst = self._slot[req.id]
        hit_cap = _next_pow2(hit)
        kind, ref = src
        if kind == "slot":
            if ref == dst:  # can't happen (promotion precedes rebinding)
                self.prefix_fallbacks += 1
                return 0
            self._call(("prefix_copy", self.pool_slots, hit_cap),
                       copy_prefix_rows, self._pool, ref, dst, hit, hit_cap,
                       self.max_len, rid=req.id, stage="prefix_copy")
        else:
            entry = self._store.get(ref)
            if entry is None:
                self.prefix_fallbacks += 1
                return 0
            cap = min(hit_cap, entry["cap"])
            self._call(("prefix_paste", self.pool_slots, entry["cap"], cap),
                       paste_prefix, self._pool, entry["cache"], dst, hit,
                       cap, entry["cap"], self.max_len, rid=req.id,
                       stage="prefix_copy")
        self.prefix_copy_device_calls += 1
        self.kv_bytes_prefix_copied += hit_cap * self._kv_token_bytes
        self._row_pos[req.id] = hit
        return hit

    def _ensure_row_at(self, req: Request, seq_start: int):
        """Pool row positioned at ``seq_start``: the slot is allocated at
        prefill START and its reused row invalidated by the next chunk's
        ``fresh`` program; a matched prefix is copied in (never forwarded)
        before any tail runs, and sets the row position to the hit so the
        first tail bucket does not reset the row; a discard-style
        preemption that reset the scheduler's chunk progress re-invalidates
        the row and replays the already-prefilled prefix, re-copying the
        prefix too (the pinned node keeps its source alive)."""
        rid = req.id
        if rid in self._slot and self._row_pos.get(rid) == seq_start:
            return
        if rid not in self._slot:
            self._alloc_slot(rid)
        self._row_pos[rid] = None  # sentinel: next bucket resets the row
        self._nxt_dev.pop(rid, None)
        done = 0
        hit = min(self._hit.get(rid, 0), seq_start)
        if hit > 0:
            done = self._copy_prefix(req, hit)
        if seq_start > done:
            self._run_bucketed_in_pool(req, done, seq_start - done)

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
            kvl, emit = _next_pow2(pos), pos >= req.prompt_len
            nxt = self._call(
                ("prefill_chunk", self.pool_slots, sizes, buf.shape[1], kvl,
                 fresh, emit), self._prefill_chunk, sizes, buf, gstart,
                self._slot[rid], kv_limit=kvl, fresh=fresh, emit=emit,
                rid=rid, stage="prefill")
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
        if self.cfg.is_encoder_decoder:
            # guarded again here, as in the reference, so no subclass can
            # reach the slot pool with cross state reset_row leaves stale
            raise NotImplementedError(self._ENC_DEC_MSG)
        if on_token is not None:
            self._on_token[req.id] = on_token
        if self.in_pool_prefill and req.tokens is not None:
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

    def deadline_expired(self, req: Request, now: float) -> bool:
        if self._faults is not None and \
                self._faults.fires("deadline", req_id=req.id):
            return True
        return super().deadline_expired(req, now)

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
        tr = self.tracer
        if not tr.on:
            return self._prefill_piece(req, seq_start, tokens)
        t = time.perf_counter_ns()
        tr.flow_mark(req.id, "sched.queued", t)  # its first prefill work
        sp = tr.open("backend.chunk", req.id, start=t,
                     tokens=tokens, pos=seq_start)
        self._prefill_piece(req, seq_start, tokens)
        tr.close(sp)

    def _prefill_piece(self, req: Request, seq_start: int,
                       tokens: int) -> None:
        self._track_prefill(req.id)
        try:
            if self.in_pool_prefill:
                self._ensure_row_at(req, seq_start)
                self._run_bucketed_in_pool(req, seq_start, tokens)
            else:
                self._ensure_scratch_at(req, seq_start)
                self._run_bucketed(req, seq_start, tokens)
        except FaultError as e:
            self._record_flow_fault(req, e, "prefill")

    def prefill_done(self, req: Request, now: float) -> None:
        if req.id in self._quarantined:
            return
        self._untrack_prefill(req.id)
        tr = self.tracer
        sp = tr.open("backend.prefill_finish", req.id) if tr.on else None
        try:
            self._prefill_done(req, now)
        except FaultError as e:
            self._record_flow_fault(req, e, "prefill")
        if sp is not None:
            tr.close(sp)

    def _prefill_done(self, req: Request, now: float) -> None:
        rid = req.id
        if self.in_pool_prefill:
            if req.tokens is None or rid not in self._slot:
                return
            nxt = self._nxt_dev.pop(rid, None)
            if nxt is None:
                # prefill made entirely of zero-length chunks: no program
                # ran and there is no token to decode on; return the slot
                heapq.heappush(self._free, self._slot.pop(rid))
                self._row_pos.pop(rid, None)
                return
            first = int(self._to_host(nxt, rid))  # this prefill's one sync
            self.host_syncs += 1
            self.prefill_host_syncs += 1
            self._row_pos.pop(rid, None)
        else:
            # the _first guard covers a prefill made entirely of zero-length
            # chunks: no forward ran, so there is no token to bind a slot on
            if req.tokens is None or rid not in self._scratch \
                    or rid not in self._first:
                return
            slot = self._alloc_slot(rid)
            first = self._first.pop(rid)
            self._call(("bind", self.pool_slots), self._bind,
                       self._scratch.pop(rid), slot, self._nxt_dev.pop(rid),
                       rid=rid, stage="prefill")
            self._scratch_pos.pop(rid, None)
            self.bind_device_calls += 1
            self.kv_bytes_prefill += self._bind_row_bytes
        # host-known row progress: decode dispatches derive their pow-2
        # kv_limit from the max live position of the batch (§9)
        self._slot_pos[self._slot[rid]] = req.prompt_len
        # index the finished prompt as a donor (DESIGN.md §10), but only
        # when the row can NEVER ring-wrap (wrap would overwrite the donated
        # prefix); the gate is static per request, so the sim models it too
        if self._prefix is not None \
                and req.prompt_len + req.max_new_tokens <= self.max_len:
            path, evicted = self._prefix.insert(_prompt_key(req))
            slot = self._slot[rid]
            for n in path:
                self._set_source(n, ("slot", slot))
            for n in evicted:
                self._set_source(n, None)
        self._last[rid] = first
        self._texts[rid] = [first]
        self._emit_first(req, first)

    # -- decode ---------------------------------------------------------------
    def decode_run(self, reqs: List[Request], n_steps: int,
                   now: float) -> None:
        """Commit to a membership-stable run.  Abortable mode (default)
        launches only the first segment now and the rest lazily as the
        replay buffer drains, so a reactive arrival between segments cancels
        the unlaunched remainder (``request_preempt``)."""
        live = [r for r in reqs if r.id in self._slot
                and r.id not in self._quarantined]
        if not live or n_steps <= 1 or not self.device_resident:
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
        t0 = time.perf_counter_ns()
        tr = self.tracer
        sp = tr.open("backend.segment", start=t0) if tr.on else None
        blocks = []
        for b in _pow2_buckets(n):
            rows, kvl = self._elastic_extent(slots, b)
            block = self._decode_call(b, rows, kvl, fused=True)
            self.decode_device_calls += 1
            self._account_decode(slots, b, rows, kvl)
            blocks.append(block)
        full = self._to_host(self._torch.cat(blocks))  # the one host sync
        t1 = time.perf_counter_ns()
        if sp is not None:
            tr.close(sp, t1, steps=n, live=len(slots), rows=rows,
                     kv_limit=kvl)
        seg_wall = (t1 - t0) / 1e9
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
        tr = self.tracer
        sp = tr.open("backend.decode_step") if tr.on else None
        batch = None
        if self.device_resident:
            self._sync_mask(slots)
        else:
            # legacy (pre-donation) hot path: rebuild the batch state on the
            # host and upload it every iteration
            np, torch = self._np, self._torch
            mask_h = np.zeros((self.pool_slots,), bool)
            toks_h = np.zeros((self.pool_slots,), np.int32)
            for r in live:
                mask_h[self._slot[r.id]] = True
                toks_h[self._slot[r.id]] = self._last[r.id]
            batch = (torch.from_numpy(toks_h).to(self.device),
                     torch.from_numpy(mask_h).to(self.device))
        rows, kvl = self._elastic_extent(slots, 1)
        nxt = self._decode_call(1, rows, kvl, fused=False, batch=batch)
        self.decode_device_calls += 1
        self._account_decode(slots, 1, rows, kvl)
        nxt = self._to_host(nxt)  # the one host sync of this iteration
        self.host_syncs += 1
        self._commit(live, nxt)
        if sp is not None:
            tr.close(sp, live=len(live), rows=rows, kv_limit=kvl)

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
        tr = self.tracer
        sp = tr.open("backend.emit", rows=len(live)) if tr.on else None
        for r in live:
            t = int(tokens_by_slot[self._slot[r.id]])
            self._last[r.id] = t
            self._texts[r.id].append(t)
            self._emit(r, t)
        if sp is not None:
            tr.close(sp)

    def _drop_flow_state(self, rid: int) -> None:
        """Free one flow's slot and host bookkeeping (``finish`` and
        ``quarantine_flow``).  ``_texts`` survives: ``output_tokens()``
        outlives the run."""
        slot = self._slot.pop(rid, None)
        if slot is not None:
            try:
                self._call(("clear", self.pool_slots), self._clear_slot, slot,
                           rid=rid, stage="finish")
            except FaultError:
                # an injected fault at the finish boundary fires BEFORE the
                # launch, so forcing the clear through is a clean re-launch:
                # slot reclamation must never leak on a cleanup fault
                self.flow_faults += 1
                self._clear_slot(slot)
            self._mask_host[slot] = False
            self._slot_pos.pop(slot, None)
            heapq.heappush(self._free, slot)
        self._untrack_prefill(rid)
        self._last.pop(rid, None)
        self._scratch.pop(rid, None)
        self._scratch_pos.pop(rid, None)
        self._first.pop(rid, None)
        self._on_token.pop(rid, None)
        self._tok_dev.pop(rid, None)
        self._row_pos.pop(rid, None)
        self._nxt_dev.pop(rid, None)
        # release the consumer's prefix pin; the request's OWN donated
        # prefix (if indexed at prefill_done) outlives it: the freed row
        # keeps its KV until rebinding promotes the prefix to the store
        self._hit.pop(rid, None)
        node = self._hit_node.pop(rid, None)
        if node is not None and self._prefix is not None:
            self._prefix.unpin(node)
        if self.tracer.on:  # retired before its first token, if at all
            self.tracer.flow_drop(rid)

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
    def _emit_first(self, req: Request, first: int):
        """Emit a prefill's first token: the end of its ``sched.prefill``
        span (and of ``sched.queued``, for a prefill that ran no chunk)."""
        tr = self.tracer
        if not tr.on:
            return self._emit(req, first)
        t = time.perf_counter_ns()
        tr.flow_mark(req.id, "sched.queued", t)
        tr.flow_mark(req.id, "sched.prefill", t)
        with tr.span("backend.emit", req.id, rows=1):
            self._emit(req, first)

    def _emit(self, req: Request, token: int):
        """Per-token user-hook boundary: an exception from ONE flow's
        callback is parked as a ``FlowFault`` (the flow is quarantined as
        ``failed``) while every other flow keeps streaming."""
        if req.id in self._quarantined:
            return
        cb = self._on_token.get(req.id)
        try:
            if self._faults is not None:
                self._faults.check("hook", req_id=req.id)
            if cb is not None:
                cb(req, token)
        except Exception as e:
            self._record_flow_fault(req, e, "hook")

    def output_tokens(self, req_id: int) -> list:
        return self._texts.get(req_id, [])

    # -- bounded-resource accounting (DESIGN.md §12) --------------------------
    def kv_store_rows(self) -> int:
        return len(self._store)

    def evict_prefix_leaves(self) -> int:
        """Degradation-ladder rung 1: force-evict every unpinned node and
        drop its physical source; store entries whose last node departs
        are freed (real KV rows back)."""
        if self._prefix is None:
            return 0
        before = len(self._store)
        nodes = self._prefix.evict_unpinned()
        for n in nodes:
            self._set_source(n, None)
        self.pressure_evicted_nodes += len(nodes)
        return before - len(self._store)

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
        if self._prefix is not None:
            problems += self._validate_prefix()
        if strict and problems:
            raise InvariantViolation("; ".join(problems))
        return problems

    def _validate_prefix(self) -> List[str]:
        """Prefix accounting: node sources, store refcounts, pins."""
        problems: List[str] = []
        refs: Dict[int, int] = {}
        stack = [self._prefix.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            src = nd.source
            if src is None:
                continue
            kind, ref = src
            if kind == "slot":
                if nd not in self._slot_nodes.get(ref, set()):
                    problems.append(f"node {nd.nid} claims slot {ref} but "
                                    f"is not in _slot_nodes")
            else:
                if ref not in self._store:
                    problems.append(f"node {nd.nid} references dropped "
                                    f"store entry {ref}")
                refs[ref] = refs.get(ref, 0) + 1
        for eid, entry in self._store.items():
            if entry["refs"] != refs.get(eid, 0):
                problems.append(f"store entry {eid} refcount {entry['refs']}"
                                f" != {refs.get(eid, 0)} referencing nodes")
            if entry["refs"] <= 0:
                problems.append(f"store entry {eid} kept at refs<=0")
        # consumer pins: every pinned node's refs equals its pin count
        pins: Dict[int, int] = {}
        by_id: Dict[int, object] = {}
        for node in self._hit_node.values():
            pins[id(node)] = pins.get(id(node), 0) + 1
            by_id[id(node)] = node
        for key, n_pins in pins.items():
            node = by_id[key]
            if node.refs != n_pins:
                problems.append(f"node {node.nid} refs {node.refs} != "
                                f"{n_pins} in-flight consumer pins")
        if set(self._hit) != set(self._hit_node):
            problems.append(f"hit/hit_node key mismatch: {sorted(self._hit)}"
                            f" vs {sorted(self._hit_node)}")
        return problems

    def stats(self) -> dict:
        """The reference's keys, with the same values on the same trace."""
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
                **(self._faults.stats() if self._faults is not None
                   else {}),
                "kv_dtype": self.kv_dtype,
                "kernel_backend": self.kernel_backend,
                "quant_scale_bytes": self.quant_scale_bytes,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_hit_rate": self.prefix_hit_tokens
                / max(self.prefix_prompt_tokens, 1),
                "kv_bytes_prefix_copied": self.kv_bytes_prefix_copied,
                "prefix_copy_device_calls": self.prefix_copy_device_calls,
                "prefix_promotions": self.prefix_promotions,
                "prefix_fallbacks": self.prefix_fallbacks,
                "prefix_store_entries": len(self._store),
                "prefill_forward_tokens": self.prefill_forward_tokens,
                **self._contention_stats(),
                **(self._prefix.stats() if self._prefix is not None
                   else {})}

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


class DualDeviceBackend(TorchRealBackend):
    """Stage-decoupled execution (DESIGN.md §14): prefill on a second lane
    while decode, and the KV pool it owns, stay on the backend's device and
    its current stream.  The port of the reference's ``DualDeviceBackend``.

    The prefill lane (``launch.mesh``): a second GPU when one is visible,
    as in the reference; on one GPU the same GPU with a ``torch.cuda.Stream``
    of its own, two lanes sharing HBM the way the paper's NPU and iGPU share
    DDR; an explicit ``prefill_device`` equal to the decode device is such a
    lane too, and on the CPU it runs the staged code in order.  Without a
    lane (``prefill_device=None`` and no GPU) every flow co-locates, as the
    reference does on one device.

    A staged prefill forwards its prompt chunks through a B=1 staging cache
    on the prefill lane, the next-token scalar kept there between chunks:
    no host sync in the prompt phase.  At ``prefill_done`` the cache's ring
    is truncated to the prompt's pow-2 ``cap`` (a view), moved to the
    decode device when that is another GPU, and installed into a freshly
    allocated pool row by ``kvcache.handoff_row`` on the decode stream,
    which first waits on an event recorded after the last staged launch.
    The one host sync of the prefill fetches the first token on the prefill
    lane, so it waits on that lane's chain only.  Staging caches are
    recycled (``reset_row(cache, 0)``, bounded by ``prefill_inflight_max``);
    a recycled cache is reset only after an event recorded behind its
    install on the decode stream, and a cache read on the decode stream is
    marked for it in the caching allocator (``record_stream``).

    Elastic binding (HEG), decided once per request: a prefill co-locates
    on the decode lane (the inherited in-pool path, identical tokens) when
    there is no second lane, when it has a prefix-cache hit (the matched KV
    lives in the decode pool), at ``prefill_inflight_max`` staged prefills
    (backpressure), or when the HEG prices the prefill lane more than 5%
    above the decode lane for the tail.  The scheduler drives the same hook
    sequence either way, so sim and real traces stay equal.
    """

    name = "torch-dual"

    def __init__(self, cfg, params, *, prefill_device=None,
                 prefill_inflight_max: int = 8, heg=None, **kw):
        super().__init__(cfg, params, **kw)
        self.heg = heg
        self.prefill_inflight_max = max(int(prefill_inflight_max), 1)
        self.decode_device = self.device
        lane = self._prefill_lane(prefill_device)
        # staging leans on in-pool prefill and the device-resident decode
        # tail: the baselines co-locate wholesale, as in the reference
        self.dual_device = lane is not None and self.in_pool_prefill \
            and self.device_resident
        self.prefill_device = lane.device if self.dual_device \
            else self.device
        self._pf_stream = lane.stream if self.dual_device else None
        self._params_pf = None
        if self.dual_device:
            from repro_torch.models import module_from_state_dict
            self._params_pf = params if self.prefill_device == self.device \
                else module_from_state_dict(params.state_dict(),
                                            device=self.prefill_device)
        if self._pf_stream is not None:
            # the weights (and their copy) were written on the current
            # streams: the prefill lane starts after them
            torch = self._torch
            self._pf_stream.wait_stream(torch.cuda.current_stream(
                self.device))
            self._pf_stream.wait_stream(torch.cuda.current_stream(
                self.prefill_device))
        self._staged: set = set()  # rids prefilling on the prefill lane
        self._stage_decision: Dict[int, bool] = {}  # sticky per request
        self._tok_dev_pf: Dict[int, object] = {}  # prompt uploads, pf lane
        # recycled staging caches: [cache, event after its install] (the
        # event is None until the install is queued)
        self._staging_free: List[list] = []
        self.staged_prefills = 0
        self.prefill_inflight_peak = 0
        self.handoff_device_calls = 0  # pool installs of staged rows
        self.kv_bytes_handoff = 0  # ring bytes moved across the handoff
        self.colocated_hits = 0  # fallbacks: prefix hit on the decode pool
        self.colocated_backpressure = 0  # fallbacks: staging queue full
        self.colocated_affinity = 0  # fallbacks: HEG priced the lane out

    def _prefill_lane(self, prefill_device):
        """The prefill ``Lane``, or None (co-located execution)."""
        from repro_torch.launch.mesh import (Lane, MeshDeviceError,
                                             dual_stage_devices)
        torch = self._torch
        if prefill_device is None:
            try:
                return dual_stage_devices(self.device)[1]
            except MeshDeviceError:
                return None
        dev = torch.device(prefill_device)
        if dev.type != self.device.type:
            raise ValueError(f"prefill_device {dev} is not a lane of the "
                             f"decode device's kind ({self.device})")
        if dev.type != "cuda":
            return Lane(dev, None)  # the CPU lane: the staged code in order
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Lane(dev, torch.cuda.Stream(dev))

    def _on_lane(self):
        """Context in which work is issued on the prefill lane."""
        import contextlib
        if self._pf_stream is None:
            return contextlib.nullcontext()
        return self._torch.cuda.stream(self._pf_stream)

    def _lane_name(self) -> str:
        if not self.dual_device or self.prefill_device != self.device:
            return str(self.prefill_device)
        if self._pf_stream is None:
            return f"{self.prefill_device} (in-order lane)"
        return f"{self.prefill_device} (stream {self._pf_stream.stream_id})"

    # -- elastic binding (HEG affinity / backpressure / hit fallbacks) --------
    def _stage_for(self, req: Request, seq_start: int) -> bool:
        """Decide (once, stickily) whether this request prefills on the
        prefill lane or co-locates on the decode lane."""
        rid = req.id
        dec = self._stage_decision.get(rid)
        if dec is not None:
            return dec
        stage = self.dual_device
        if stage and self._hit.get(rid, 0) > 0:
            stage = False
            self.colocated_hits += 1
        if stage and len(self._staged) >= self.prefill_inflight_max:
            stage = False
            self.colocated_backpressure += 1
        if stage and self.heg is not None:
            # co-locate only when the HEG prices the prefill lane more than
            # 5% worse for this tail (staging is the default)
            tail = max(req.prompt_len - seq_start, 1)
            if self.heg.prefill_time_estimate(tail, "npu") > \
                    1.05 * self.heg.prefill_time_estimate(tail, "igpu"):
                stage = False
                self.colocated_affinity += 1
        self._stage_decision[rid] = stage
        if stage:
            self._staged.add(rid)
            self.staged_prefills += 1
            self.prefill_inflight_peak = max(self.prefill_inflight_peak,
                                             len(self._staged))
        return stage

    # -- staged prefill (prefill lane) ----------------------------------------
    def _upload_prompt_pf(self, req: Request):
        """Pow-2-padded prompt tokens on the prefill lane (the decode
        lane's twin is ``_tok_dev``); pinned and asynchronous on a GPU, so
        the staged chunks issue no host sync."""
        rid = req.id
        buf = self._tok_dev_pf.get(rid)
        if buf is None:
            np = self._np
            toks = np.asarray(req.tokens, np.int32).reshape(1, -1)
            pad = np.zeros((1, _next_pow2(max(toks.shape[1], 1))), np.int32)
            pad[:, :toks.shape[1]] = toks
            host = self._torch.from_numpy(pad)
            with self._on_lane():
                if self.prefill_device.type == "cuda":
                    buf = host.pin_memory().to(self.prefill_device,
                                               non_blocking=True)
                else:
                    buf = host.to(self.prefill_device)
            self._tok_dev_pf[rid] = buf
        return buf

    def _staged_reset(self, item):
        """Recycle a used staging cache to the fresh-bind state, once the
        decode stream has read its last entry."""
        from repro_torch.models import reset_row
        cache, installed = item
        with self._on_lane():
            if installed is not None:
                self._pf_stream.wait_event(installed)
            return reset_row(cache, 0)

    def _staged_extend(self, cache, buf, start: int, c: int):
        """One pow-2 bucket against the staging cache on the prefill lane,
        its tokens sliced from the resident prompt; the next token stays
        there as a device scalar."""
        from repro_torch.models import extend
        with self._on_lane():
            logits, cache = extend(self.cfg, self._params_pf, cache,
                                   buf[:, start:start + c],
                                   kernel_backend=self.kernel_backend)
            return logits.argmax(-1).to(self._torch.int32)[0], cache

    def _ensure_staged_at(self, req: Request, seq_start: int):
        """Staging cache positioned at ``seq_start``: rebuilt (replaying the
        already-prefilled prefix) after a discard-style preemption reset the
        scheduler's chunk progress.  Rides in the ``_scratch`` bookkeeping,
        so every teardown path already covers it."""
        from repro_torch.models import init_cache
        rid = req.id
        if rid in self._scratch and self._scratch_pos[rid] == seq_start:
            return
        if self._staging_free:
            cache = self._call(("staged_reset",), self._staged_reset,
                               self._staging_free.pop(), rid=rid,
                               stage="prefill")
            self.prefill_device_calls += 1
        else:
            with self._on_lane():
                cache = init_cache(self.cfg, self._params_pf, 1,
                                   self.max_len, self.dtype,
                                   kv_dtype=self._kv_dtype_arg,
                                   device=self.prefill_device)
        self._scratch[rid] = cache
        self._scratch_pos[rid] = 0
        self._nxt_dev.pop(rid, None)
        if seq_start > 0:
            self._run_staged(req, 0, seq_start)

    def _run_staged(self, req: Request, start: int, n: int):
        if n <= 0:  # zero-length chunk: nothing ran, ``nxt`` never exists
            return
        rid = req.id
        buf = self._upload_prompt_pf(req)
        pos = start
        for size in _pow2_buckets(n):
            nxt, self._scratch[rid] = self._call(
                ("staged_extend", size, buf.shape[1]), self._staged_extend,
                self._scratch[rid], buf, pos, size, rid=rid, stage="prefill")
            self.prefill_device_calls += 1
            pos += size
        self._scratch_pos[rid] = pos
        self.kv_bytes_prefill += n * self._kv_token_bytes
        self.prefill_forward_tokens += n
        if pos >= req.prompt_len:
            # the first token stays on the prefill lane: the one host sync
            # per prefill happens at the handoff, never per chunk
            self._nxt_dev[rid] = nxt

    def _prefill_piece(self, req: Request, seq_start: int,
                       tokens: int) -> None:
        if not self._stage_for(req, seq_start):
            super()._prefill_piece(req, seq_start, tokens)
            return
        self._track_prefill(req.id)
        try:
            self._ensure_staged_at(req, seq_start)
            self._run_staged(req, seq_start, tokens)
        except FaultError as e:
            self._record_flow_fault(req, e, "prefill")

    # -- KV handoff (prefill lane -> decode pool) -----------------------------
    def _to_decode_lane(self, entry, nxt):
        """The truncated entry and the first token as the decode lane reads
        them, and the event the decode stream waits on before it does (None
        on the CPU lane).  On another GPU both are copied across, queued
        behind the prefill lane's chain."""
        torch = self._torch
        if self._pf_stream is None:
            return entry, nxt, None
        from repro_torch.models.kvcache import _map_states
        with self._on_lane():
            if self.prefill_device != self.device:
                dev = self.device
                moved = _map_states(
                    lambda n, a, x: x.to(dev, non_blocking=True), entry)
                moved["pos"] = entry["pos"].to(dev, non_blocking=True)
                entry, nxt = moved, nxt.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._pf_stream)
        return entry, nxt, ready

    def _handoff(self, entry, slot: int, cap: int, first_dev, ready,
                 recycled) -> None:
        """Install ``entry`` into pool row ``slot`` and commit the first
        token to the token vector, on the decode stream after ``ready``."""
        from repro_torch.models import handoff_row
        from repro_torch.models.kvcache import _leaves
        torch = self._torch
        if ready is not None:
            dec = torch.cuda.current_stream(self.device)
            dec.wait_event(ready)
            if self.prefill_device == self.device:
                # prefill-lane memory read here: the caching allocator must
                # not hand it back out before the decode stream is done
                for t in (*_leaves(entry), first_dev):
                    t.record_stream(dec)
        handoff_row(self._pool, entry, slot, cap, self.max_len)
        self._toks.narrow(0, slot, 1).copy_(first_dev.reshape(1))
        if ready is not None and recycled is not None:
            recycled[1] = torch.cuda.Event()
            recycled[1].record(dec)

    def _prefill_done(self, req: Request, now: float) -> None:
        from repro_torch.models import truncate_rings
        rid = req.id
        if rid not in self._staged:
            self._stage_decision.pop(rid, None)
            return super()._prefill_done(req, now)
        nxt = self._nxt_dev.pop(rid, None)
        cache = self._scratch.pop(rid, None)
        self._scratch_pos.pop(rid, None)
        self._staged.discard(rid)
        self._stage_decision.pop(rid, None)
        if req.tokens is None or nxt is None or cache is None:
            # staged prefill made entirely of zero-length chunks: no program
            # ran, no pool slot was ever bound: nothing to hand off
            return
        # bound the handoff to the prompt's pow-2 ring prefix (prefill
        # positions never wrap: prompt_len <= max_len by engine contract)
        cap = min(_next_pow2(max(req.prompt_len, 1)), self.max_len)
        entry = cache
        if cap < self.max_len:
            entry = self._call(("staged_trunc", cap), truncate_rings, cache,
                               cap, self.max_len, rid=rid, stage="prefill")
        entry, first_dev, ready = self._to_decode_lane(entry, nxt)
        # recycle the staging cache for the next staged prefill; its reset
        # waits on the event the install below records
        recycled = None
        if len(self._staging_free) < self.prefill_inflight_max:
            recycled = [cache, None]
            self._staging_free.append(recycled)
        if rid not in self._slot:
            self._alloc_slot(rid)
        slot = self._slot[rid]
        self._call(("handoff", self.pool_slots, cap), self._handoff, entry,
                   slot, cap, first_dev, ready, recycled, rid=rid,
                   stage="prefill")
        self.handoff_device_calls += 1
        self.kv_bytes_handoff += cap * self._kv_token_bytes
        # the ONE host sync of this prefill, on the prefill lane: it waits
        # on that lane's chain only, never on queued decode segments
        with self._on_lane():
            first = int(self._to_host(nxt, rid))
        self.host_syncs += 1
        self.prefill_host_syncs += 1
        self._slot_pos[slot] = req.prompt_len
        # donor indexing mirrors the in-pool branch (same wrap gate), so
        # staged prompts land on the decode pool as prefix sources too
        if self._prefix is not None \
                and req.prompt_len + req.max_new_tokens <= self.max_len:
            path, evicted = self._prefix.insert(_prompt_key(req))
            for node in path:
                self._set_source(node, ("slot", slot))
            for node in evicted:
                self._set_source(node, None)
        self._last[rid] = first
        self._texts[rid] = [first]
        self._emit_first(req, first)

    def _drop_flow_state(self, rid: int) -> None:
        # mid-prefill abort / quarantine / release of a staged flow: the
        # staging cache rides in _scratch (cleared by super), the rest here
        self._staged.discard(rid)
        self._stage_decision.pop(rid, None)
        self._tok_dev_pf.pop(rid, None)
        super()._drop_flow_state(rid)

    def stats(self) -> dict:
        out = super().stats()
        out.update({
            "dual_device": self.dual_device,
            "prefill_device": self._lane_name(),
            "decode_device": str(self.decode_device),
            "staged_prefills": self.staged_prefills,
            "prefill_inflight_peak": self.prefill_inflight_peak,
            "handoff_device_calls": self.handoff_device_calls,
            "kv_bytes_handoff": self.kv_bytes_handoff,
            "colocated_hits": self.colocated_hits,
            "colocated_backpressure": self.colocated_backpressure,
            "colocated_affinity": self.colocated_affinity,
        })
        return out
