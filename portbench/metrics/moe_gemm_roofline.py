"""moe_gemm_roofline: the summed least time of the ``ops.moe_gemm`` calls
in the profiled span (``roofline.moe_gemm_bound``: live rows and the
weights of the experts that have one, at 3.35 TB/s or 989 TFLOP/s), over
the device time of the expert GEMM's kernels there, in %."""
from portbench import roofline

WRAPS = {"moe_gemm": roofline.moe_gemm_bound}
KERNELS = ("moe_",)


def read(r):
    return roofline.share(r, "moe_gemm_roofline", KERNELS)
