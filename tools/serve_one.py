"""One full-width bf16 serve of ``chip_smoke.py`` (its 8-flow trace through
the port's engine, the served tokens held to the plain path), alone, on one
NVIDIA GPU, from the checkout in the working directory.

    python3 tools/serve_one.py [ARCH]      # default recurrentgemma-9b

Run from the root of two checkouts in turn (a parent and a change, each
building its own kernels) to compare one serving path's wall and tokens
without the rest of ``chip_smoke.py``; prints the serve's ``[serve]`` and
``[check]`` lines and its stats.
"""
import os
import sys

root = os.getcwd()
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "src"))

import chip_smoke as cs  # noqa: E402

cs.device_phase()
from repro_torch.kernels import build  # noqa: E402

build.build()
cfg, params = cs._init(sys.argv[1] if len(sys.argv) > 1 else cs.RG_ARCH)
st = cs.bf16_serve(cfg, params)
print("RESULT", {k: st[k] for k in st
                 if k in ("wall_s", "tok_s", "reactive_ttft_s")}, flush=True)
