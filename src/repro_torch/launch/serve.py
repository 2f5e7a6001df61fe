"""Serving launcher of the port: Agent.xpu engine over an agentic workload
trace (``repro.launch.serve``'s flags, defaults and printed lines, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --scheduler agent.xpu --rate 1.0 --horizon 300
    PYTHONPATH=src python -m repro_torch.launch.serve --real --horizon 30
    PYTHONPATH=src python -m repro_torch.launch.serve --real --device cpu \
        --kernel-backend plain --horizon 30

Default mode is the timing simulator (paper-figure methodology), which
imports no torch; --real runs actual token generation with a tiny model
(random f32 weights from seed 0) under the same scheduler, on CUDA unless
``--device cpu`` asks for the CPU (``--device cuda`` raises without a GPU).
``--prefill-device N`` stages prefill on a second lane (DESIGN.md §14): GPU
``N``, which on one GPU, ``N`` being the decode GPU, is a second stream of
it; with ``--device cpu`` the staged code runs in order on the CPU.
Without it, staging is on when two GPUs are visible (``--no-dual-device``
pins one lane).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config, get_tiny_config
from repro_torch.core import (AgentXPUEngine, WorkloadConfig,
                              generate_workload)
from repro_torch.core.annotation import PROFILES
from repro_torch.core.engine import RealAgentXPUEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--scheduler", default="agent.xpu",
                    choices=["agent.xpu", "fcfs", "naive_preempt",
                             "timeshare", "continuous_batching"])
    ap.add_argument("--hw", default="intel_core_ultra_5_125h",
                    choices=list(PROFILES))
    ap.add_argument("--rate", type=float, default=0.5,
                    help="proactive requests/s (Poisson)")
    ap.add_argument("--reactive-interval", type=float, default=20.0)
    ap.add_argument("--proactive-profile", default="samsum")
    ap.add_argument("--reactive-profile", default="lmsys_chat")
    ap.add_argument("--horizon", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--real", action="store_true",
                    help="actually generate tokens (tiny model)")
    ap.add_argument("--stream", action="store_true",
                    help="with --real: print tokens as they are generated")
    ap.add_argument("--max-fused-steps", type=int, default=32,
                    help="with --real: cap on fused decode run length "
                         "(1 disables fusion — per-iteration device calls)")
    ap.add_argument("--decode-segment-steps", type=int, default=8,
                    help="abortable-run segment length: fused runs execute "
                         "lazily in segments this long, so a reactive "
                         "arrival is noticed within one segment")
    ap.add_argument("--no-abortable-runs", action="store_true",
                    help="execute announced fused runs eagerly and never "
                         "truncate plans (the eager baseline of "
                         "BENCH_reactive.json)")
    ap.add_argument("--pool-slots", type=int, default=None,
                    help="with --real: KV slot-pool size (default: the "
                         "HEG batching knee B_max; doubles on demand)")
    ap.add_argument("--no-device-resident", action="store_true",
                    help="with --real: disable buffer donation / on-device "
                         "batch state / fused runs, and fall back to "
                         "scratch+bind prefill (the full pre-donation "
                         "baseline of BENCH_decode.json)")
    ap.add_argument("--no-in-pool-prefill", action="store_true",
                    help="with --real: prefill into a per-request scratch "
                         "cache and bind-scatter it at completion (double "
                         "KV write; baseline of BENCH_prefill.json)")
    ap.add_argument("--no-elastic-decode", action="store_true",
                    help="with --real: dispatch every decode over the FULL "
                         "pool_slots x max_len cache instead of the pow-2 "
                         "live-row / live-prefix bounds (the full-pool "
                         "baseline of BENCH_decode.json's scaling sweep)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix KV reuse: every prompt "
                         "prefills cold even when its prefix is already "
                         "resident (the baseline of BENCH_prefill.json's "
                         "prefix_reuse entry)")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="with --real: KV-pool storage dtype. int8 stores "
                         "the ring as symmetric per-(slot, kv head) int8 "
                         "with f32 scales, dequantized inside the decode "
                         "program (DESIGN.md §11); bf16 is the exactness "
                         "baseline")
    ap.add_argument("--kernel-backend", default="cuda",
                    choices=["cuda", "plain"],
                    help="with --real: kernel routing. cuda runs the "
                         "hand-written kernels on the card (their plain "
                         "versions for CPU tensors); plain runs the plain "
                         "PyTorch path")
    ap.add_argument("--device", default="cuda",
                    help="with --real: cuda (default; raises without a "
                         "GPU) or cpu")
    ap.add_argument("--pool-slots-max", type=int, default=None,
                    help="hard cap on KV occupancy (live flows + prefix "
                         "snapshot rows).  At saturation arrivals walk the "
                         "degradation ladder — evict unpinned prefix "
                         "leaves, shrink the fused horizon, defer to a "
                         "bounded queue, reject (DESIGN.md §12); default: "
                         "unbounded (pool doubles on demand)")
    ap.add_argument("--admission-queue-len", type=int, default=8,
                    help="bounded admission wait-queue length (ladder "
                         "rung 3); only meaningful with --pool-slots-max")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="SLO deadline for REACTIVE requests in ms from "
                         "arrival; an expired flow is aborted at the next "
                         "segment boundary with status timed_out")
    ap.add_argument("--no-isolate-flow-faults", action="store_true",
                    help="with --real: legacy fault handling — an on_token "
                         "hook exception tears down the whole run instead "
                         "of quarantining just the faulting flow")
    ap.add_argument("--no-dual-device", action="store_true",
                    help="with --real: pin the single-lane backend even "
                         "when two GPUs are visible")
    ap.add_argument("--prefill-device", type=int, default=None,
                    help="with --real: stage prefill on GPU N (the decode "
                         "GPU's index gives a second stream of it; with "
                         "--device cpu, the CPU lane), decode and the KV "
                         "pool stay on --device")
    ap.add_argument("--prefill-inflight-max", type=int, default=8,
                    help="with --real: bound on concurrently staged "
                         "prefills of dual-device execution; beyond it a "
                         "prefill co-locates on the decode lane")
    ap.add_argument("--strict-invariants", action="store_true",
                    help="with --real: audit slot/refcount/pin accounting "
                         "after every event-loop turn and raise "
                         "InvariantViolation on any leak (also via "
                         "REPRO_STRICT_INVARIANTS=1)")
    ap.add_argument("--system-prompt-len", type=int, default=32,
                    help="with --real: shared system-prompt tokens "
                         "prepended to every prompt (agentic flows share "
                         "system prompts / tool schemas — the traffic shape "
                         "the prefix cache exists for; 0 disables)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    wl = WorkloadConfig(proactive_rate=args.rate,
                        reactive_interval=args.reactive_interval,
                        proactive_profile=args.proactive_profile,
                        reactive_profile=args.reactive_profile,
                        horizon=args.horizon, seed=args.seed)
    reqs = generate_workload(wl)

    if args.real:
        import torch
        from repro_torch.models import init_params
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--device cuda and no GPU is visible; pass "
                               "--device cpu to serve on the CPU")
        prefill_device = None
        if args.prefill_device is not None:
            prefill_device = torch.device("cuda", args.prefill_device) \
                if device.type == "cuda" else device
        cfg = get_tiny_config(args.arch)
        params = init_params(cfg, seed=0, dtype=torch.float32, device=device)
        rng = np.random.default_rng(args.seed)
        # agentic traffic shape: every flow shares the same leading system
        # prompt, so all but the first prefill can start at the hit boundary
        sys_len = max(args.system_prompt_len, 0)
        sys_toks = rng.integers(0, cfg.vocab_size, (1, sys_len)) \
            if sys_len else None
        for r in reqs:
            r.prompt_len = min(r.prompt_len, 96)
            r.max_new_tokens = min(r.max_new_tokens, 16)
            tail = rng.integers(0, cfg.vocab_size, (1, r.prompt_len))
            r.tokens = tail if sys_toks is None else \
                np.concatenate([sys_toks, tail], axis=1)
            r.prompt_len = r.tokens.shape[1]
        eng = RealAgentXPUEngine(
            cfg, params, scheduler=args.scheduler, max_len=256,
            device=device, pool_slots=args.pool_slots,
            max_fused_steps=args.max_fused_steps,
            abortable_runs=not args.no_abortable_runs,
            decode_segment_steps=args.decode_segment_steps,
            device_resident=not args.no_device_resident,
            in_pool_prefill=False if args.no_in_pool_prefill else None,
            elastic_decode=not args.no_elastic_decode,
            prefix_cache=not args.no_prefix_cache,
            kv_dtype=args.kv_dtype, kernel_backend=args.kernel_backend,
            pool_slots_max=args.pool_slots_max,
            admission_queue_len=args.admission_queue_len,
            deadline_s=None if args.deadline_ms is None
            else args.deadline_ms / 1000.0,
            isolate_flow_faults=not args.no_isolate_flow_faults,
            strict_invariants=True if args.strict_invariants else None,
            dual_device=False if args.no_dual_device
            else (True if prefill_device is not None else None),
            prefill_device=prefill_device,
            prefill_inflight_max=args.prefill_inflight_max)
        from repro_torch.core.engine import stream_printer
        on_token = stream_printer() if args.stream else None
        for r in reqs:
            eng.submit(r, on_token=on_token)
        metrics = eng.run()
        if not args.json:
            st = eng.stats()
            print(f"[real] {st['jit_compilations']} jit compilations, "
                  f"{st['decode_device_calls']} decode device calls, "
                  f"{st['host_syncs']} host syncs, "
                  f"{st['fused_steps']} fused decode steps "
                  f"in {st['fused_runs']} runs "
                  f"({st['decode_segments']} segments), "
                  f"{st['pool_slots']} pool slots")
            print(f"[real] preemption: {st['aborted_runs']} runs truncated "
                  f"({st['aborted_steps']} unlaunched steps cancelled)")
            print(f"[real] elastic decode: last dispatch "
                  f"{st['decode_rows']}/{st['pool_slots']} rows x "
                  f"kv_limit {st['decode_kv_limit']}/256, "
                  f"{st['kv_bytes_decode']} KV bytes streamed")
            print(f"[real] kv pool: dtype {st['kv_dtype']}, "
                  f"kernel backend {st['kernel_backend']}, "
                  f"{st['quant_scale_bytes']} quant scale bytes")
            print(f"[real] prefill: {st['prefill_device_calls']} device "
                  f"calls, {st['prefill_host_syncs']} host syncs, "
                  f"{st['bind_device_calls']} bind scatters, "
                  f"{st['kv_bytes_prefill']} KV bytes written")
            print(f"[real] prefix cache: {st['prefix_hits']} hit prefills, "
                  f"{st['prefix_hit_tokens']} prompt tokens copied not "
                  f"recomputed (hit rate {st['prefix_hit_rate']:.2f}), "
                  f"{st['kv_bytes_prefix_copied']} KV bytes copied, "
                  f"{st['prefix_store_entries']} store entries, "
                  f"{st['prefix_promotions']} donor promotions")
            if st.get("dual_device"):
                print(f"[real] dual device: prefill on "
                      f"{st['prefill_device']}, decode on "
                      f"{st['decode_device']}, {st['staged_prefills']} "
                      f"staged prefills ({st['prefill_inflight_peak']} peak "
                      f"in flight), {st['handoff_device_calls']} handoffs "
                      f"({st['kv_bytes_handoff']} KV bytes), co-located: "
                      f"{st['colocated_hits']} prefix-hit / "
                      f"{st['colocated_backpressure']} backpressure / "
                      f"{st['colocated_affinity']} affinity")
            slowdown = st["co_execution_decode_slowdown_measured"]
            print(f"[real] contention: peak pressure "
                  f"{st['contention_pressure_peak']:.2f}, "
                  f"{st['co_executed_segments']} co-executed decode "
                  f"segments (rate {st['co_execution_rate']:.2f}), decode "
                  f"slowdown under prefill: "
                  f"{'n/a' if slowdown is None else f'{slowdown:.2f}x'} "
                  f"measured / "
                  f"{st['co_execution_decode_slowdown_model']:.2f}x "
                  f"modeled")
            cap = st["pool_slots_max"]
            print(f"[real] failure model: pool cap "
                  f"{'unbounded' if cap is None else cap} "
                  f"({st['free_slots']} slots free at exit), "
                  f"{st['flow_faults']} flow faults "
                  f"({st['quarantined_flows']} quarantined), "
                  f"{st['device_fault_retries']} transient device retries, "
                  f"{st['pressure_evicted_nodes']} pressure-evicted "
                  f"prefix nodes")
    else:
        from repro_torch.core.backend import SimBackend
        cfg = get_config(args.arch)
        if args.deadline_ms is not None:
            for r in reqs:
                if r.priority.name == "REACTIVE" and r.deadline is None:
                    r.deadline = args.deadline_ms / 1000.0
        eng = AgentXPUEngine(cfg, hw=PROFILES[args.hw],
                             scheduler=args.scheduler,
                             abortable_runs=not args.no_abortable_runs,
                             decode_segment_steps=args.decode_segment_steps,
                             pool_slots_max=args.pool_slots_max,
                             admission_queue_len=args.admission_queue_len)
        # sim traces carry no token ids, so hits only arise when a caller
        # fills them in — the knob still gates the modeled accounting
        eng.backend = SimBackend(prefix_cache=not args.no_prefix_cache)
        metrics = eng.run_trace(reqs)

    s = metrics.summary()
    sched = eng.last_sched
    if sched is not None:
        # degradation-ladder / failure counters (DESIGN.md §12)
        s["admission_deferrals"] = sched.admission_deferrals
        s["admission_rejections"] = sched.admission_rejections
        s["pressure_evictions"] = sched.pressure_evictions
        s["horizon_shrinks"] = sched.horizon_shrinks
        s["deadline_aborts"] = sched.deadline_aborts
        s["fault_quarantines"] = sched.fault_quarantines
    if args.json:
        print(json.dumps(s, indent=2))
    else:
        print(f"[serve] {args.scheduler} on {args.arch} "
              f"({len(reqs)} requests, rate {args.rate}/s)")
        for k, v in s.items():
            print(f"  {k:26s} {v}")


if __name__ == "__main__":
    main()
