"""Train any assigned architecture's tiny variant end-to-end on the PyTorch
port (with checkpoint/resume) -- ``examples/train_tiny.py`` over
``repro_torch.launch.train`` -- e.g. the MoE or the RWKV6 family:

    PYTHONPATH=src python examples/train_tiny_torch.py --arch rwkv6-1.6b --steps 100
    PYTHONPATH=src python examples/train_tiny_torch.py --arch qwen2-moe-a2.7b \\
        --device cpu --steps 20

Every arch that ``repro_torch.models.check_trainable`` accepts trains; the
launcher's ``--device`` (default cuda, which raises without a GPU) and
``--kernel-backend cuda|plain`` pass through.  Checkpoints go to
``repro_torch_ckpt`` in the temporary directory unless ``--ckpt-dir`` says
otherwise.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if "--tiny" not in argv:
        argv = argv + ["--tiny"]
    if not any(a.startswith("--ckpt-dir") for a in argv):
        argv += ["--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                            "repro_torch_ckpt")]
    main(argv)
