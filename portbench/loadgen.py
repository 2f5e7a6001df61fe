"""Traffic: a seeded request schedule from a traffic file, and the
closed-loop generator that offers it to the serving front end.

A traffic file (``portbench/traffic/<name>.json``) gives client classes,
each with a client count, a think-time law and lognormal prompt and output
lengths (mean, std, clipped to [min, max]), and optionally a set of shared
documents that a class's prompts start with.  The lengths, think times
and documents are the same sequence for every seed: each block of
``block`` requests of a class holds the block's stratified quantiles of
the law, in an order drawn from the traffic file's ``order_seed`` and the
class's place in the file, so that every run offers the same work; the
seed draws the token ids.

Every prompt segment the benchmark draws (a document, a question, a plain
prompt) starts with a token no other segment of the run starts with, so a
prompt shares a prefix with another only where the traffic says it does.

``ClosedLoop`` runs in one thread, the caller's: a client sends its next
request when the last has finished (its last token's wall instant) plus
its think time.  A request's latencies count from the instant it was due,
so a generator that runs late adds to them; its lag is recorded.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# how often the generator looks for finished requests: coarse enough that
# its wake-ups take the interpreter lock from the engine thread rarely
POLL_S = 0.02


@dataclass
class Job:
    """One request as the traffic defines it."""
    cls: str
    priority: str
    tokens: np.ndarray  # (prompt_len,) int64
    max_new_tokens: int
    think_s: float  # the client's pause after this request finished
    doc: int = -1  # index of the shared document it starts with, or -1


@dataclass
class Sent:
    """One request as it was offered: its job, due and submit instants,
    and the front end's handle."""
    job: Job
    client: int
    due: float
    submitted: float
    handle: object

    @property
    def done(self) -> bool:
        return self.handle.status is not None


def _lognormal_quantiles(n: int, mean: float, std: float) -> np.ndarray:
    """The n stratified quantiles ((i + 0.5) / n) of the lognormal law
    with this mean and std."""
    from statistics import NormalDist
    s2 = math.log(1.0 + (std / mean) ** 2)
    mu = math.log(mean) - s2 / 2
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.exp(mu + math.sqrt(s2) * z)


def _think_quantiles(n: int, law: dict) -> np.ndarray:
    if law["dist"] == "const":
        return np.full(n, float(law["value"]))
    if law["dist"] == "exp":
        u = (np.arange(n) + 0.5) / n
        return -float(law["mean"]) * np.log1p(-u)
    raise ValueError(f"unknown think-time law {law['dist']!r}")


def _clip_len(x: float, law: dict) -> int:
    return int(min(max(round(x), law["min"]), law["max"]))


class Schedule:
    """The run's requests, drawn from the traffic file and the seed:
    ``documents`` (each an int64 array) and, per class, an endless
    sequence of jobs (``next_job``)."""

    def __init__(self, traffic: dict, vocab_size: int, seed: int,
                 max_len: int):
        self.traffic = traffic
        self.vocab = int(vocab_size)
        self.max_len = int(max_len)
        self.block = int(traffic.get("block", 64))
        self._rng = np.random.default_rng(int(seed))
        # first tokens of every segment, all distinct (a permutation)
        self._firsts = iter(self._rng.permutation(self.vocab))
        docs = traffic.get("documents") or {}
        self.documents = [self._segment(int(docs["tokens"]))
                          for _ in range(int(docs.get("count", 0)))]
        self._queues: Dict[str, List[Job]] = {}
        self.classes = {c["name"]: c for c in traffic["classes"]}
        # one order generator a class: a class's sequence does not depend
        # on when the other classes refill theirs
        order = int(traffic.get("order_seed", 0))
        self._orders = {c["name"]: np.random.default_rng([order, i])
                        for i, c in enumerate(traffic["classes"])}

    def _segment(self, n: int) -> np.ndarray:
        toks = self._rng.integers(0, self.vocab, size=n, dtype=np.int64)
        toks[0] = next(self._firsts)
        return toks

    def _refill(self, c: dict) -> None:
        b = self.block
        rng = self._orders[c["name"]]
        plen = _lognormal_quantiles(b, c["prompt"]["mean"],
                                    c["prompt"]["std"])[rng.permutation(b)]
        olen = _lognormal_quantiles(b, c["output"]["mean"],
                                    c["output"]["std"])[rng.permutation(b)]
        think = _think_quantiles(b, c["think_s"])[rng.permutation(b)]
        q = self._queues.setdefault(c["name"], [])
        ndoc = len(self.documents)
        for i in range(b):
            p = _clip_len(plen[i], c["prompt"])
            o = _clip_len(olen[i], c["output"])
            doc = -1
            if c.get("document"):
                doc = int(rng.integers(0, ndoc))
                head = self.documents[doc]
                p = min(p, self.max_len - len(head) - o)
                toks = np.concatenate([head, self._segment(p)])
            else:
                p = min(p, self.max_len - o)
                toks = self._segment(p)
            q.append(Job(c["name"], c["priority"], toks, o, float(think[i]),
                         doc))

    def next_job(self, cls: str) -> Job:
        q = self._queues.get(cls)
        if not q:
            self._refill(self.classes[cls])
            q = self._queues[cls]
        return q.pop(0)


@dataclass
class ClosedLoop:
    """Closed-loop clients of every class over one front end, driven from
    the calling thread (``run_until``)."""
    schedule: Schedule
    submit: object  # callable(job) -> handle
    sent: List[Sent] = field(default_factory=list)
    lags: List[float] = field(default_factory=list)

    def __post_init__(self):
        self._clients = []  # [class name, next due, in-flight Sent or None]
        now = time.perf_counter()
        for c in self.schedule.traffic["classes"]:
            for _ in range(int(c["clients"])):
                self._clients.append([c["name"], now, None])

    def _step(self, now: float, stop: Optional[float]) -> float:
        """Retire finished requests and send those due; returns the next
        instant anything is due (inf while every client waits)."""
        nxt = math.inf
        for i, cl in enumerate(self._clients):
            s = cl[2]
            if s is not None:
                if not s.done:
                    continue
                walls = s.handle.token_walls
                end = walls[-1] if walls else now
                cl[1] = end + s.job.think_s
                cl[2] = None
            if stop is not None and cl[1] >= stop:
                continue
            if cl[1] <= now:
                job = self.schedule.next_job(cl[0])
                h = self.submit(job)
                t = time.perf_counter()
                snt = Sent(job, i, cl[1], t, h)
                self.sent.append(snt)
                self.lags.append(t - cl[1])
                cl[2] = snt
            else:
                nxt = min(nxt, cl[1])
        return nxt

    def run_until(self, stop: float) -> None:
        """Serve the loop until ``stop`` (perf_counter): no request due
        at or after it is sent."""
        while True:
            now = time.perf_counter()
            if now >= stop:
                return
            nxt = self._step(now, stop)
            time.sleep(max(0.0, min(POLL_S, nxt - now, stop - now)))

    def in_flight(self) -> List[Sent]:
        return [cl[2] for cl in self._clients
                if cl[2] is not None and not cl[2].done]
