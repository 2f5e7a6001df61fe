"""Plain float32 reference of qwen2-moe-a2.7b (Qwen1.5-MoE-A2.7B) as the
configuration file states it: pre-norm decoder layers of GQA attention
(16 / 16 heads of 128, q/k/v biases, rotate-half RoPE at rope_theta) and a
sparse MoE FFN (60 experts of 1408, top 4 renormalised, 4 x 1408 shared
experts added ungated), RMSNorm, untied LM head.  Departures from the
published model are listed in the configuration file's ``departures``.

``logits(config, weights, seqs, product)``: each sequence is (tokens (S,)
int64, MoE token groups, positions whose logits are wanted); returns one
float32 (n, vocab) tensor a sequence.  Layer by layer over every sequence,
so one layer's weights are upcast at a time.
"""
from __future__ import annotations

import importlib.util
import os

import torch

_spec = importlib.util.spec_from_file_location(
    "portbench_reference_plain",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_plain.py"))
plain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)

ATTN = ("norm1.w", "norm2.w", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
        "attn.bq", "attn.bk", "attn.bv")
MOE = ("moe.router", "moe.experts.wg", "moe.experts.w1", "moe.experts.w2",
       "moe.shared.wg", "moe.shared.w1", "moe.shared.w2")


def logits(config, weights, seqs, product="f32"):
    plain.no_tf32()
    mm = plain.PRODUCTS[product]
    d = config["hidden_size"]
    H, Hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = d // H
    eps = config["rms_norm_eps"]
    theta = float(config["rope_theta"])
    K = config["num_experts_per_tok"]
    emb = weights["embed.w"]
    hs = [emb[t].float() for t, _, _ in seqs]
    poss = [torch.arange(len(t), device=emb.device) for t, _, _ in seqs]
    groups, off = [], 0
    for (t, g, _) in seqs:
        groups += [(off + s, n, lim) for s, n, lim in g]
        off += len(t)
    for r in range(config["num_hidden_layers"]):
        w = plain.layer_weights(weights, "blocks.0.", r, ATTN + MOE)
        for i, (h, pos) in enumerate(zip(hs, poss)):
            a = plain.rms_norm(h, w["norm1.w"], eps)
            S = h.shape[0]
            q = (mm(a, w["attn.wq"]) + w["attn.bq"]).view(S, H, hd)
            k = (mm(a, w["attn.wk"]) + w["attn.bk"]).view(S, Hkv, hd)
            v = (mm(a, w["attn.wv"]) + w["attn.bv"]).view(S, Hkv, hd)
            q, k = plain.rope(q, pos, theta), plain.rope(k, pos, theta)
            k = k.repeat_interleave(H // Hkv, dim=1)
            v = v.repeat_interleave(H // Hkv, dim=1)
            o = plain.causal_attention(q, k, v, plain.attention_scale(hd))
            hs[i] = h + mm(o.reshape(S, H * hd), w["attn.wo"])
        x = torch.cat(hs)
        b = plain.rms_norm(x, w["norm2.w"], eps)
        y = plain.routed_experts(b, w["moe.router"], w["moe.experts.wg"],
                                 w["moe.experts.w1"], w["moe.experts.w2"],
                                 K, groups, mm)
        y = y + plain.gated_mlp(b, w["moe.shared.wg"], w["moe.shared.w1"],
                                w["moe.shared.w2"], mm)
        x = x + y
        hs = list(x.split([h.shape[0] for h in hs]))
        del w
    return [plain.lm_logits(h[want], weights, eps, mm)
            for h, (_, _, want) in zip(hs, seqs)]
