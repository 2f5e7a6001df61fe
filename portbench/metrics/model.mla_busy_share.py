"""model.mla_busy_share: device time of the kernels launched inside the
``record_function`` range the benchmark opens around the MLA attention
functions (``RANGES``), over the device's busy time in the profiled span,
in %."""

RANGES = {"mla_attention": ("repro_torch.models.transformer",
                            ("mla_decode_attention",
                             "mla_prefill_attention"))}


def read(r):
    p = r.profile
    if not p or p["busy_s"] <= 0:
        return None
    t = p["ranges"].get("mla_attention")
    return 100.0 * t / p["busy_s"] if t else None
