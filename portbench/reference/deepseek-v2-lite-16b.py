"""Plain float32 reference of deepseek-v2-lite-16b (DeepSeek-V2-Lite) as
the configuration file states it: pre-norm decoder layers of multi-head
latent attention (q projected directly; the latent c = RMSNorm(x W_dkv) of
kv_lora_rank, keys c W_uk beside a shared rotate-half RoPE key x W_krope,
values c W_uv, scored at 1 / sqrt(qk_nope + qk_rope), in the expanded
form), a dense gated FFN in the first first_k_dense_replace layers and a
sparse MoE FFN after (64 experts of 1408, top 6 renormalised, 2 x 1408
shared experts), RMSNorm, untied LM head.  Departures from the published
model are listed in the configuration file's ``departures``.

``logits(config, weights, seqs, product)``: as the other references.
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

ATTN = ("norm1.w", "norm2.w", "attn.w_q", "attn.w_dkv", "attn.w_krope",
        "attn.w_uk", "attn.w_uv", "attn.wo", "attn.kv_norm")
DENSE = ("ffn.wg", "ffn.w1", "ffn.w2")
MOE = ("moe.router", "moe.experts.wg", "moe.experts.w1", "moe.experts.w2",
       "moe.shared.wg", "moe.shared.w1", "moe.shared.w2")


def _layers(config):
    """(tree prefix, repeat index or None, dense FFN) in execution order."""
    nd = config["first_k_dense_replace"]
    out = [(f"head.{i}.", None, True) for i in range(nd)]
    out += [("blocks.0.", r, False)
            for r in range(config["num_hidden_layers"] - nd)]
    return out


def logits(config, weights, seqs, product="f32"):
    plain.no_tf32()
    mm = plain.PRODUCTS[product]
    H = config["num_attention_heads"]
    dn, dr = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, rank = config["v_head_dim"], config["kv_lora_rank"]
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
    for prefix, r, dense in _layers(config):
        w = plain.layer_weights(weights, prefix, r,
                                ATTN + (DENSE if dense else MOE))
        w_uk = w["attn.w_uk"].reshape(rank, H * dn)
        w_uv = w["attn.w_uv"].reshape(rank, H * dv)
        for i, (h, pos) in enumerate(zip(hs, poss)):
            S = h.shape[0]
            a = plain.rms_norm(h, w["norm1.w"], eps)
            q = mm(a, w["attn.w_q"]).view(S, H, dn + dr)
            q_rope = plain.rope(q[..., dn:], pos, theta)
            c = plain.rms_norm(mm(a, w["attn.w_dkv"]), w["attn.kv_norm"],
                               eps)
            kr = plain.rope(mm(a, w["attn.w_krope"])[:, None, :], pos, theta)
            k_nope = mm(c, w_uk).view(S, H, dn)
            v = mm(c, w_uv).view(S, H, dv)
            qq = torch.cat([q[..., :dn], q_rope], dim=-1)
            kk = torch.cat([k_nope, kr.expand(S, H, dr)], dim=-1)
            o = plain.causal_attention(qq, kk, v,
                                       plain.attention_scale(dn + dr))
            hs[i] = h + mm(o.reshape(S, H * dv), w["attn.wo"])
        x = torch.cat(hs)
        b = plain.rms_norm(x, w["norm2.w"], eps)
        if dense:
            y = plain.gated_mlp(b, w["ffn.wg"], w["ffn.w1"], w["ffn.w2"], mm)
        else:
            y = plain.routed_experts(b, w["moe.router"], w["moe.experts.wg"],
                                     w["moe.experts.w1"],
                                     w["moe.experts.w2"], K, groups, mm)
            y = y + plain.gated_mlp(b, w["moe.shared.wg"],
                                    w["moe.shared.w1"], w["moe.shared.w2"],
                                    mm)
        x = x + y
        hs = list(x.split([h.shape[0] for h in hs]))
        del w
    return [plain.lm_logits(h[want], weights, eps, mm)
            for h, (_, _, want) in zip(hs, seqs)]
