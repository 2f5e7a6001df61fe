"""End-to-end agentic serving example on the PyTorch port: a mixed
proactive/reactive trace served with REAL batched token generation under the
Agent.xpu scheduler, streamed per token, with per-class latency/throughput
and compilation/device-call report -- ``examples/serve_agentic.py`` over
``repro_torch`` (the tiny variant of the arch, f32 weights from seed 0).

    PYTHONPATH=src python examples/serve_agentic_torch.py --n-proactive 6
    PYTHONPATH=src python examples/serve_agentic_torch.py --device cpu

``--device cuda`` (the default) raises when no GPU is visible;
``--kernel-backend cuda`` (the default) runs the hand-written CUDA kernels
on a GPU, ``plain`` the plain PyTorch path -- identical tokens on the CPU.
The report's counters are the port's ``stats()`` keys, the reference's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_tiny_config
from repro_torch.core.engine import RealAgentXPUEngine, stream_printer
from repro_torch.core.requests import Priority, Request
from repro_torch.models import init_params
from repro_torch.models.transformer import KERNEL_BACKENDS


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b",
                    help="any assigned arch (tiny variant is served)")
    ap.add_argument("--n-proactive", type=int, default=6)
    ap.add_argument("--out-tokens", type=int, default=12)
    ap.add_argument("--scheduler", default="agent.xpu")
    ap.add_argument("--stream", action="store_true",
                    help="print every token as it is generated")
    ap.add_argument("--max-fused-steps", type=int, default=32,
                    help="cap on fused decode run length (1 = no fusion)")
    ap.add_argument("--decode-segment-steps", type=int, default=8,
                    help="abortable-run segment length")
    ap.add_argument("--no-abortable-runs", action="store_true",
                    help="eager fused runs, no plan truncation")
    ap.add_argument("--no-elastic-decode", action="store_true",
                    help="full-pool decode dispatch: every iteration "
                         "computes all pool rows over the whole max_len "
                         "ring (the decode-scaling-sweep baseline)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix KV reuse: every prompt "
                         "prefills cold (the hit-vs-cold baseline)")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="KV-pool storage: int8 ring + f32 per-(slot, kv "
                         "head) scales, dequantized inside the decode "
                         "program (DESIGN.md §11)")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=KERNEL_BACKENDS,
                    help="kernel routing: cuda runs the hand-written "
                         "kernels (their plain versions on CPU tensors), "
                         "plain the plain PyTorch path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--system-prompt-len", type=int, default=24,
                    help="shared system-prompt tokens prepended to every "
                         "flow's prompt (0 disables); with the prefix "
                         "cache on, flows after the first start prefill "
                         "at the hit boundary")
    ap.add_argument("--pool-slots-max", type=int, default=None,
                    help="hard KV occupancy cap; saturated arrivals walk "
                         "the degradation ladder (evict -> shrink -> defer "
                         "-> reject, DESIGN.md §12) instead of growing "
                         "the pool")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="reactive SLO deadline in ms from arrival; an "
                         "expired flow is aborted at the next segment "
                         "boundary (status timed_out)")
    ap.add_argument("--no-isolate-flow-faults", action="store_true",
                    help="legacy: an on_token hook exception tears down "
                         "the whole run instead of quarantining one flow")
    ap.add_argument("--strict-invariants", action="store_true",
                    help="audit slot/refcount/pin accounting after every "
                         "event-loop turn (also REPRO_STRICT_INVARIANTS=1)")
    ap.add_argument("--inject-mid-stream", action="store_true",
                    help="submit the reactive request from an on_token "
                         "callback DURING the run (streaming arrival path) "
                         "instead of scheduling it in the trace")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda and no GPU is visible; pass "
                           "--device cpu to run on the CPU")

    cfg = get_tiny_config(args.arch)
    if cfg.frontend != "none" or cfg.is_encoder_decoder:
        raise SystemExit("pick a text-only arch for this example")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=device)
    print(f"serving tiny {args.arch} ({cfg.num_params()/1e6:.1f}M) "
          f"with {args.scheduler}")

    rng = np.random.default_rng(0)
    # every flow of the agent shares one system prompt / tool schema —
    # the traffic shape shared-prefix KV reuse (DESIGN.md §10) exists for
    sys_len = max(args.system_prompt_len, 0)
    sys_toks = rng.integers(0, cfg.vocab_size, (1, sys_len)) \
        if sys_len else None

    def mk_tokens(tail_len):
        tail = rng.integers(0, cfg.vocab_size, (1, tail_len))
        return tail if sys_toks is None else \
            np.concatenate([sys_toks, tail], axis=1)

    reqs = []
    for i in range(args.n_proactive):
        toks = mk_tokens(int(rng.integers(24, 96)))
        reqs.append(Request(
            id=i, priority=Priority.PROACTIVE, prompt_len=toks.shape[1],
            max_new_tokens=args.out_tokens, arrival_time=i * 0.01,
            tokens=toks))
    # the user interrupts mid-stream
    toks = mk_tokens(48)
    reactive = Request(
        id=len(reqs), priority=Priority.REACTIVE, prompt_len=toks.shape[1],
        max_new_tokens=args.out_tokens, arrival_time=0.08,
        tokens=toks)
    if not args.inject_mid_stream:
        reqs.append(reactive)

    eng = RealAgentXPUEngine(cfg, params, scheduler=args.scheduler,
                             max_len=256, device=device,
                             max_fused_steps=args.max_fused_steps,
                             abortable_runs=not args.no_abortable_runs,
                             decode_segment_steps=args.decode_segment_steps,
                             elastic_decode=not args.no_elastic_decode,
                             prefix_cache=not args.no_prefix_cache,
                             kv_dtype=args.kv_dtype,
                             kernel_backend=args.kernel_backend,
                             pool_slots_max=args.pool_slots_max,
                             deadline_s=None if args.deadline_ms is None
                             else args.deadline_ms / 1000.0,
                             isolate_flow_faults=not
                             args.no_isolate_flow_faults,
                             strict_invariants=True
                             if args.strict_invariants else None)
    printer = stream_printer() if args.stream else None
    state = {"tokens": 0, "injected": False}
    # fire well inside the run even for tiny --out-tokens traces
    inject_at = min(4 * args.n_proactive,
                    max(1, args.n_proactive * args.out_tokens // 2))

    def on_token(req, token):
        state["tokens"] += 1
        # streaming arrival: the "user" hits enter a few tokens into the
        # proactive decode stream — submit() lands in the LIVE run and a
        # committed fused plan is truncated at the next segment boundary
        if args.inject_mid_stream and not state["injected"] \
                and state["tokens"] >= inject_at:
            state["injected"] = True
            eng.submit(reactive, on_token=on_token)
        if printer is not None:
            printer(req, token)

    for r in reqs:
        eng.submit(r, on_token=on_token)
    m = eng.run()
    s = m.summary()
    print(f"\nretired {len(m.completed)} requests "
          f"({s['n_completed']} completed, {s['n_failed']} failed, "
          f"{s['n_timed_out']} timed out, {s['n_rejected']} rejected; "
          f"sim time {m.sim_time:.2f}s)")
    for r in sorted(m.completed, key=lambda r: r.id):
        toks = eng.output_tokens(r.id)
        ttft = f"{r.ttft * 1e3:7.1f}ms" if r.ttft is not None else "    n/a"
        e2e = f"{r.e2e_latency:6.3f}s" if r.e2e_latency is not None \
            else "   n/a"
        print(f"  req {r.id} [{r.priority.name:9s}] "
              f"{r.terminal_status or r.state.value:9s} ttft={ttft} "
              f"e2e={e2e} preempts={r.preempt_count} "
              f"tokens={toks[:6]}...")
    def ms(v):
        return f"{v * 1e3:.1f} ms" if v is not None else "n/a"
    print(f"\nreactive TTFT       : {ms(s['reactive_ttft'])}")
    print(f"proactive TTFT      : {ms(s['proactive_ttft'])}")
    print(f"proactive mean e2e  : {s['proactive_e2e']:.3f} s")
    print(f"energy              : {s['energy_j_per_token']:.2f} J/token")
    st = eng.stats()
    decode_tokens = sum(r.decoded - 1 for r in m.completed)
    print(f"jit compilations    : {st['jit_compilations']}")
    print(f"decode device calls : {st['decode_device_calls']} for "
          f"{decode_tokens} decode tokens "
          f"(pool of {st['pool_slots']} slots)")
    print(f"fused decode steps  : {st['fused_steps']} "
          f"in {st['fused_runs']} fused runs "
          f"({st['decode_segments']} abortable segments)")
    print(f"aborted fused runs  : {st['aborted_runs']} "
          f"({st['aborted_steps']} unlaunched steps cancelled on "
          f"reactive arrival/join)")
    pig = getattr(eng.last_sched, "piggyback_runs", 0)
    pig_steps = getattr(eng.last_sched, "piggyback_steps", 0)
    print(f"piggybacked runs    : {pig} fused runs ({pig_steps} steps) "
          f"committed under live prefills")
    print(f"elastic decode      : last dispatch {st['decode_rows']}"
          f"/{st['pool_slots']} rows x kv_limit {st['decode_kv_limit']}/256 "
          f"({st['kv_bytes_decode']} KV bytes streamed)")
    print(f"kv pool             : dtype {st['kv_dtype']}, kernel backend "
          f"{st['kernel_backend']}, {st['quant_scale_bytes']} quant "
          f"scale bytes")
    print(f"host syncs          : {st['host_syncs']} "
          f"(one per fused segment boundary, not per token)")
    print(f"prefill device calls: {st['prefill_device_calls']} "
          f"({st['prefill_host_syncs']} host syncs — one per request)")
    print(f"bind scatters       : {st['bind_device_calls']} "
          f"(0 = zero-copy in-pool prefill)")
    print(f"prefill KV written  : {st['kv_bytes_prefill']} bytes")
    print(f"prefix reuse        : {st['prefix_hits']} hit prefills, "
          f"{st['prefix_hit_tokens']} prompt tokens copied not recomputed "
          f"(hit rate {st['prefix_hit_rate']:.2f})")
    print(f"prefix KV copied    : {st['kv_bytes_prefix_copied']} bytes in "
          f"{st['prefix_copy_device_calls']} bounded copies "
          f"({st['prefix_promotions']} donor rows promoted to the "
          f"{st['prefix_store_entries']}-entry store)")
    sched = eng.last_sched
    cap = st["pool_slots_max"]
    print(f"admission ladder    : cap "
          f"{'unbounded' if cap is None else cap}, "
          f"{sched.pressure_evictions} pressure evictions, "
          f"{sched.horizon_shrinks} horizon shrinks, "
          f"{sched.admission_deferrals} deferrals, "
          f"{sched.admission_rejections} rejections")
    print(f"fault isolation     : {st['flow_faults']} flow faults "
          f"({st['quarantined_flows']} flows quarantined), "
          f"{st['device_fault_retries']} transient device retries, "
          f"{sched.deadline_aborts} deadline aborts, "
          f"{st['free_slots']}/{st['pool_slots']} slots free at exit")


if __name__ == "__main__":
    main()
