"""attention_roofline: the summed least time of the ``ops.decode_attention``
and ``ops.flash_attention_pool`` calls in the profiled span
(``roofline.decode_bound`` / ``pool_bound``: the valid ring slots and
query-slot pairs), over the device time of the attention kernels (the
split decode kernel and its merge, the pool kernel), in %."""
from portbench import roofline

WRAPS = {"decode_attention": roofline.decode_bound,
         "flash_attention_pool": roofline.pool_bound}
KERNELS = ("decode_mma_kernel", "decode_kernel", "merge_kernel",
           "pool_mma_kernel", "flash_pool_kernel")


def read(r):
    return roofline.share(r, "attention_roofline", KERNELS)
