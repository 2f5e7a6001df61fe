"""The comparison that decides ``correct``: served tokens against the plain
reference.

After the window closes and the program's state is freed, a sample of the
requests the run finished (drawn from the seed, with the longest in it)
goes through the configuration's reference once: each prompt with its
served tokens, in float32.  At every served position the gap is the
reference's best logit minus its logit of the served token.  The number
compared is the mean gap over the sample, in units of the reference
logits' standard deviation over the vocabulary (so that one limit reads
alike at any width), against the cell's limit
(``portbench/limits/<cell>.json``).  Greedy decoding serves the argmax of
the program's own logits, so the gap is what the program's rounding cost.
The widest gap is reported beside it and not compared: bf16 routing
near-ties put it as high as the fp8 control's, so it separates no fault
from rounding.

The reference is told how the serving path groups a prompt's tokens for
the routed experts' capacity (``moe_groups``): the prompt in chunks of the
configuration's prefill chunk from position 0, each cut into descending
powers of two, each piece one capacity group; every served token's step is
dropless.  A shared document is a multiple of the chunk long, so a prompt
that starts with a cached document is grouped alike whether its prefix was
copied or computed.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def pow2_pieces(n: int):
    """Descending powers of two summing to n (96 -> [64, 32])."""
    out, b = [], 1
    while b * 2 <= n:
        b *= 2
    while n > 0:
        while b > n:
            b //= 2
        out.append(b)
        n -= b
    return out


def moe_groups(prompt_len: int, n_served: int, chunk: int):
    """(start, length, limited) token groups of one served request's
    sequence of prompt_len + n_served - 1 tokens."""
    groups, pos = [], 0
    while pos < prompt_len:
        c = min(chunk, prompt_len - pos)
        for p in pow2_pieces(c):
            groups.append((pos, p, True))
            pos += p
    for i in range(n_served - 1):
        groups.append((prompt_len + i, 1, False))
    return groups


def load_reference(config_name: str):
    path = os.path.join(HERE, "reference", f"{config_name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_reference_" + config_name.replace("-", "_")
        .replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pick_sample(done, n: int, seed: int):
    """Up to n finished requests: the longest (prompt + served), then
    others drawn from the seed."""
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: len(done[i][0]) + len(done[i][1]))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([int(seed), 7])
    rng.shuffle(rest)
    return [done[i] for i in [longest] + rest[:n - 1]]


def sequences(sample, chunk: int, device):
    """The reference's inputs: (tokens, MoE groups, wanted positions) for
    each (prompt, served) pair of the sample."""
    import torch
    seqs = []
    for prompt, served in sample:
        P, n = len(prompt), len(served)
        toks = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(served[:-1], np.int64)])
        want = torch.arange(P - 1, P - 1 + n, device=device)
        seqs.append((torch.from_numpy(toks).to(device),
                     moe_groups(P, n, chunk), want))
    return seqs


def gaps(logits, sample):
    """Per served token: the reference's best logit minus its logit of
    the served token, and the standard deviation of the reference's logits
    over the vocabulary there (float64 numpy, each)."""
    import torch
    out, sd = [], []
    for lg, (_, served) in zip(logits, sample):
        idx = torch.as_tensor(np.asarray(served, np.int64), device=lg.device)
        best = lg.max(-1).values
        out.append((best - lg.gather(1, idx[:, None])[:, 0]).double().cpu()
                   .numpy())
        sd.append(lg.double().std(-1).cpu().numpy())
    if not out:
        return np.zeros(0), np.zeros(0)
    return np.concatenate(out), np.concatenate(sd)


def judge(config: dict, weights: dict, sample, chunk: int, device,
          product: str = "f32", blocks: int = 4):
    """The served tokens' gaps under the reference (``product`` "f32"), or,
    for the control (``product`` "fp8"), the gaps under the float32
    reference of the tokens the fp8 reference puts first.  The sample runs
    in blocks of ``blocks`` requests so that the reference fits."""
    ref = load_reference(config["name"])
    out, sds, agree = [], [], []
    for b in range(0, len(sample), blocks):
        part = sample[b:b + blocks]
        seqs = sequences(part, chunk, device)
        lg32 = ref.logits(config, weights, seqs, "f32")
        if product == "f32":
            g, sd = gaps(lg32, part)
        else:
            lgq = ref.logits(config, weights, seqs, product)
            firsts = [(p, lq.argmax(-1).cpu().numpy())
                      for (p, _), lq in zip(part, lgq)]
            g, sd = gaps(lg32, firsts)
        out.append(g)
        sds.append(sd)
        agree += [(lg.argmax(-1).cpu().numpy() == np.asarray(s)).tolist()
                  for lg, (_, s) in zip(lg32, part)]
        del lg32
    g = np.concatenate(out) if out else np.zeros(0)
    sd = np.concatenate(sds) if sds else np.zeros(0)
    flat = [a for row in agree for a in row]
    nan = float("nan")
    return {"mean_gap_sd": float(g.mean() / sd.mean()) if g.size else nan,
            "widest_gap": float(g.max()) if g.size else nan,
            "mean_gap": float(g.mean()) if g.size else nan,
            "logit_sd": float(sd.mean()) if sd.size else nan,
            "tokens": int(g.size),
            "argmax_share": float(np.mean(flat)) if flat else nan}
