"""Evaluation CLI alias: ``python -m cld_tpu_torch.test --vae-ckpt ...
--dm-ckpt ...`` is ``python -m cld_tpu_torch.train --mode test ...`` (the
JAX package's `test.py`)."""

import sys

from cld_tpu_torch.train import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    main(argv if "--mode" in argv else argv + ["--mode", "test"])
