"""Recurrent-family test cases shared by the CPU parity tests
(test_torch_kernels.py, test_torch_models.py, test_torch_engine.py) and the
on-card tests (test_torch_cuda.py): the tiny configs, including a
recurrentgemma variant with a tail (and a qwen2-moe variant with a dense
head layer), and numpy scan inputs made from fixed seeds.  Imports no
JAX, so the on-card tests run where JAX is absent."""
import numpy as np

# tiny recurrentgemma-9b with the full config's unrolled (R, R) tail, which
# make_tiny drops (its tiny variant has tail_pattern=())
TAIL = "recurrentgemma-9b+tail"
RECURRENT_ARCHS = ["recurrentgemma-9b", TAIL, "rwkv6-1.6b"]
# tiny qwen2-moe-a2.7b with one dense head layer (dense_d_ff) before its MoE
# layer: the dense head without MLA, which no config of the registry has
DENSE_HEAD = "qwen2-moe-a2.7b+dense-head"


def tiny(get_tiny_config, arch):
    """The tiny config of ``arch`` from one framework's
    ``get_tiny_config`` (either framework's: both configs are equal), or
    of one of the variants above."""
    if arch == DENSE_HEAD:
        cfg = get_tiny_config("qwen2-moe-a2.7b")
        return cfg.with_overrides(name=cfg.name + "-dense-head",
                                  first_k_dense_layers=1)
    if arch != TAIL:
        return get_tiny_config(arch)
    cfg = get_tiny_config("recurrentgemma-9b")
    return cfg.with_overrides(name=cfg.name + "-tail",
                              tail_pattern=("rglru", "rglru"),
                              num_layers=cfg.num_layers + 2)


# (B, S, W): ragged S and W, a single step
RGLRU_CASES = [(2, 48, 64), (1, 37, 96), (3, 1, 130)]


def rglru_case(B, S, W, seed=0):
    """x, a_log (< 0), gate in (0, 1), h0 (nonzero) as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W), dtype=np.float32)
    a_log = -np.abs(rng.standard_normal((B, S, W), dtype=np.float32)) * 0.5
    gate = 1 / (1 + np.exp(-rng.standard_normal((B, S, W),
                                                dtype=np.float32)))
    h0 = rng.standard_normal((B, W), dtype=np.float32) * 0.2
    return x, a_log, gate.astype(np.float32), h0


# (BH, S, D): head sizes 32 and 64, ragged S, a single step
RWKV6_CASES = [(2, 64, 32), (3, 37, 32), (2, 21, 64), (4, 1, 64)]


def rwkv6_case(BH, S, D, seed=0):
    """r, k, v, w_log (< 0), u (BH, 1, D) and a nonzero f32 state0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, S, D), dtype=np.float32) * 0.5
               for _ in range(3))
    w = -np.exp(rng.standard_normal((BH, S, D), dtype=np.float32) * 0.5)
    u = rng.standard_normal((BH, 1, D), dtype=np.float32) * 0.3
    s0 = rng.standard_normal((BH, D, D), dtype=np.float32) * 0.3
    return r, k, v, w.astype(np.float32), u, s0
