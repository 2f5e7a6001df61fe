"""Attention kernel test cases shared by the CPU parity tests
(test_torch_kernels.py) and the on-card tests (test_torch_cuda.py): numpy
inputs made from fixed seeds, and the model-layout call of the pool
kernel.  Imports no JAX, so the on-card tests run where JAX is absent."""
import numpy as np
import torch

from repro_torch.kernels import ops


def ring(seed, B, S, Hkv, hd, positions):
    rng = np.random.default_rng(seed)
    kc = rng.standard_normal((B, S, Hkv, hd), dtype=np.float32)
    vc = rng.standard_normal((B, S, Hkv, hd), dtype=np.float32)
    return kc, vc, np.asarray(positions, np.int32)


def wrapped(cur, S):
    """Ring rows holding the S positions up to cur[b], slot = pos % S."""
    rows = []
    for c in cur:
        row = [int(c) - S + 1 + i for i in range(S)]
        rows.append(sorted(row, key=lambda p: p % S))
    return rows


def to_torch(*xs):
    return [torch.from_numpy(np.array(x, copy=True)) for x in xs]


def decode_case(name):
    """(q, k, v, slot_pos, cur, kwargs) numpy inputs of one decode case."""
    rng = np.random.default_rng(1)
    if name == "ring_wrap":
        B, Hq, Hkv, S, hd = 2, 4, 2, 32, 64
        cur = np.asarray([40, 55], np.int32)
        kc, vc, sp = ring(7, B, S, Hkv, hd, wrapped(cur, S))
        kw = {}
    elif name.startswith("window"):
        B, Hq, Hkv, S, hd = 1, 8, 2, 64, 32
        cur = np.asarray([S - 1], np.int32)
        kc, vc, sp = ring(9, B, S, Hkv, hd, np.arange(S)[None])
        kw = {"window": int(name.split("_")[1])}
    elif name == "per_batch_positions":
        B, Hq, Hkv, S, hd = 3, 4, 1, 64, 128
        cur = np.asarray([5, 40, 63], np.int32)
        pos = [[i if i <= c else -1 for i in range(S)] for c in cur]
        kc, vc, sp = ring(11, B, S, Hkv, hd, pos)
        kw = {}
    elif name == "kv_limit":
        B, Hq, Hkv, S, hd = 2, 4, 2, 64, 32
        cur = np.full((B,), 11, np.int32)
        kc, vc, sp = ring(12, B, S, Hkv, hd,
                           [[i if i < 12 else -1 for i in range(S)]] * B)
        kw = {"kv_limit": 16}
    elif name.startswith("hd256"):  # recurrentgemma's MQA: 16/1 heads
        B, Hq, Hkv, S, hd = 2, 16, 1, 64, 256
        cur = np.asarray([40, 47], np.int32)
        pos = [[i if i <= c else -1 for i in range(S)] for c in cur]
        kc, vc, sp = ring(14, B, S, Hkv, hd, pos)
        kw = {"window": 24} if name == "hd256_window" else {"kv_limit": 48}
    elif name == "masked_row":  # no valid slot: the finite mean of V
        B, Hq, Hkv, S, hd = 2, 4, 2, 32, 32
        cur = np.asarray([7, 0], np.int32)
        pos = [list(range(S)), [-1] * S]
        kc, vc, sp = ring(13, B, S, Hkv, hd, pos)
        kw = {}
    else:
        raise KeyError(name)
    q = rng.standard_normal((B, Hq, hd), dtype=np.float32)
    return q, kc, vc, sp, cur, kw


DECODE_CASES = ["ring_wrap", "window_8", "window_24", "per_batch_positions",
                "kv_limit", "masked_row", "hd256_window", "hd256_kv_limit"]


def pool_case(name):
    """Model-layout (B, C, H, hd) chunk + ring inputs of one pool case."""
    rng = np.random.default_rng(2)
    kw = {}
    if name.startswith("gqa"):
        Hq, Hkv = map(int, name.split("_")[1:])
        B, C, S, hd, start = 2, 16, 64, 32, 20
        pos = [[i if i < start + C else -1 for i in range(S)]] * B
        pos_q = np.broadcast_to(start + np.arange(C), (B, C))
    elif name == "ring_wrap_window":
        B, C, Hq, Hkv, S, hd, cur0 = 1, 8, 4, 2, 32, 32, 48
        pos = wrapped([cur0 + C - 1], S)
        pos_q = np.broadcast_to(cur0 + np.arange(C), (B, C))
        kw = {"window": 16}
    elif name == "kv_limit":
        B, C, Hq, Hkv, S, hd, live = 1, 8, 4, 2, 64, 32, 24
        pos = [[i if i < live else -1 for i in range(S)]]
        pos_q = np.broadcast_to(live - C + np.arange(C), (B, C))
        kw = {"kv_limit": 32}
    elif name == "hd256_window_kv_limit":  # recurrentgemma's MQA, 16/1
        B, C, Hq, Hkv, S, hd, live = 2, 20, 16, 1, 64, 256, 40
        pos = [[i if i < live else -1 for i in range(S)]] * B
        pos_q = np.broadcast_to(live - C + np.arange(C), (B, C))
        kw = {"window": 16, "kv_limit": 48}
    else:
        raise KeyError(name)
    kc, vc, sp = ring(15, B, S, Hkv, hd, pos)
    q = rng.standard_normal((B, C, Hq, hd), dtype=np.float32)
    return q, kc, vc, sp, np.ascontiguousarray(pos_q, np.int32), kw


POOL_CASES = ["gqa_4_4", "gqa_4_2", "gqa_8_1", "ring_wrap_window", "kv_limit",
              "hd256_window_kv_limit"]


def pool_call(q, k, v, pos_q, pos_kv, **kw):
    """The port's wrapper on strided (B, H, C, hd) views of model-layout
    tensors, as the model calls it."""
    o = ops.flash_attention_pool(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), pos_q, pos_kv, **kw)
    return o.transpose(1, 2)
