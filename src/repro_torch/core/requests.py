"""Agentic LLM requests and workload generators.

The paper's workload model: at most one human-initiated REACTIVE request in
flight (latency-critical), many event-driven PROACTIVE requests (throughput,
Poisson arrivals).  Reactive inter-arrival is exponential "think time" after
the previous response completes (§8.1).

Prompt/output length distributions approximate the paper's datasets
(lognormal fits; means documented per workload).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import List, Optional

import numpy as np


class Priority(enum.IntEnum):
    PROACTIVE = 0  # best-effort queue
    REACTIVE = 1  # real-time queue


class ReqState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    PREEMPTED = "preempted"
    DECODE = "decode"
    DONE = "done"
    # terminal failure lattice (DESIGN.md §12): every request retires in
    # exactly one of DONE / FAILED / TIMED_OUT / REJECTED / CANCELLED —
    # never by an unhandled exception tearing down the run
    FAILED = "failed"  # quarantined: hook raised / backend fault
    TIMED_OUT = "timed_out"  # deadline expired at a segment boundary
    REJECTED = "rejected"  # admission ladder exhausted (AdmissionRejected)
    CANCELLED = "cancelled"  # client abandoned the flow (DESIGN.md §13)


TERMINAL_STATES = (ReqState.DONE, ReqState.FAILED, ReqState.TIMED_OUT,
                   ReqState.REJECTED, ReqState.CANCELLED)


@dataclasses.dataclass
class Request:
    id: int
    priority: Priority
    prompt_len: int
    max_new_tokens: int
    arrival_time: float
    tokens: Optional[object] = None  # real-mode prompt ids (B=1 row)
    # optional SLO deadline in seconds RELATIVE to arrival: an expired flow
    # is aborted at the next segment boundary with TIMED_OUT (DESIGN.md §12)
    deadline: Optional[float] = None
    # -- runtime bookkeeping ------------------------------------------------
    state: ReqState = ReqState.QUEUED
    fault: Optional[str] = None  # cause of FAILED/TIMED_OUT/REJECTED
    prefill_done_t: Optional[float] = None  # TTFT timestamp
    finish_t: Optional[float] = None
    decoded: int = 0
    prefill_progress: int = 0  # tokens prefilled so far (chunk granularity)
    preempt_count: int = 0
    recomputed_tokens: int = 0  # discarded prefill work (scheme (a))
    prefix_hit: int = 0  # prompt tokens served from the prefix cache (§10)
    last_enqueue_t: float = 0.0

    @property
    def ttft(self) -> Optional[float]:
        return None if self.prefill_done_t is None else \
            self.prefill_done_t - self.arrival_time

    @property
    def normalized_latency(self) -> Optional[float]:
        """Paper metric: TTFT / prompt length (s/token)."""
        t = self.ttft
        return None if t is None else t / max(self.prompt_len, 1)

    @property
    def e2e_latency(self) -> Optional[float]:
        return None if self.finish_t is None else \
            self.finish_t - self.arrival_time

    @property
    def terminal_status(self) -> Optional[str]:
        """``completed / failed / timed_out / rejected`` once retired,
        else ``None`` (still in flight)."""
        if self.state == ReqState.DONE:
            return "completed"
        if self.state in TERMINAL_STATES:
            return self.state.value
        return None


# -- dataset-like length distributions (lognormal; mean/std in tokens) ------
WORKLOAD_PROFILES = {
    # proactive (paper §8.1)
    "proactivebench": dict(prompt_mean=220, prompt_std=120, out_mean=48,
                           out_std=25),
    "samsum": dict(prompt_mean=120, prompt_std=60, out_mean=28, out_std=12),
    "cnn_dailymail": dict(prompt_mean=780, prompt_std=320, out_mean=58,
                          out_std=20),
    # reactive
    "lmsys_chat": dict(prompt_mean=150, prompt_std=110, out_mean=200,
                       out_std=120),
    "mtrag": dict(prompt_mean=1500, prompt_std=600, out_mean=150, out_std=70),
    "bfcl": dict(prompt_mean=310, prompt_std=120, out_mean=42, out_std=18),
}


def _lognormal(rng, mean, std, lo=8, hi=8192) -> int:
    mu = math.log(mean ** 2 / math.sqrt(std ** 2 + mean ** 2))
    sigma = math.sqrt(math.log(1 + std ** 2 / mean ** 2))
    return int(np.clip(rng.lognormal(mu, sigma), lo, hi))


@dataclasses.dataclass
class WorkloadConfig:
    proactive_rate: float = 0.2  # requests / second (Poisson)
    reactive_interval: float = 20.0  # mean think time (exponential)
    proactive_profile: str = "samsum"
    reactive_profile: str = "lmsys_chat"
    horizon: float = 600.0  # seconds of arrivals
    seed: int = 0
    max_proactive: int = 10_000
    include_reactive: bool = True


def generate_workload(cfg: WorkloadConfig) -> List[Request]:
    """Timestamped request trace: Poisson proactive + exponential reactive.

    Reactive think time is measured from the *previous reactive completion*
    in the real system; for trace generation we approximate with think time
    from the previous reactive arrival plus its expected service (the paper
    samples traces the same way, then replays them against each engine).
    """
    rng = np.random.default_rng(cfg.seed)
    reqs: List[Request] = []
    ids = itertools.count()
    pp = WORKLOAD_PROFILES[cfg.proactive_profile]
    t = 0.0
    while t < cfg.horizon and len(reqs) < cfg.max_proactive:
        t += rng.exponential(1.0 / max(cfg.proactive_rate, 1e-9))
        if t >= cfg.horizon:
            break
        reqs.append(Request(
            id=next(ids), priority=Priority.PROACTIVE,
            prompt_len=_lognormal(rng, pp["prompt_mean"], pp["prompt_std"]),
            max_new_tokens=_lognormal(rng, pp["out_mean"], pp["out_std"],
                                      lo=4, hi=1024),
            arrival_time=t))
    if cfg.include_reactive:
        # paper invariant: at most one reactive request in flight — the next
        # question arrives think-time AFTER the previous answer, so spacing
        # includes a nominal service estimate (prefill + decode at standalone
        # rates on the paper's SoC).
        rp = WORKLOAD_PROFILES[cfg.reactive_profile]
        t = rng.exponential(cfg.reactive_interval)
        while t < cfg.horizon:
            plen = _lognormal(rng, rp["prompt_mean"], rp["prompt_std"])
            out = _lognormal(rng, rp["out_mean"], rp["out_std"],
                             lo=4, hi=1024)
            reqs.append(Request(
                id=next(ids), priority=Priority.REACTIVE, prompt_len=plen,
                max_new_tokens=out, arrival_time=t))
            nominal_service = plen * 2.5e-4 + out * 0.05
            t += nominal_service + rng.exponential(cfg.reactive_interval)
    reqs.sort(key=lambda r: r.arrival_time)
    return reqs
