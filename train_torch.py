#!/usr/bin/env python
"""Entry point of the PyTorch + CUDA port with the reference's
`python train.py ...` command line (the counterpart of `train.py`, which
runs the JAX package). All logic lives in yolo_from_scratch_tpu_torch/cli.py.

    python train_torch.py data.yaml [OPTIONS]          # train on the card
    python train_torch.py data.yaml model.ckpt [--map]  # evaluate
    python train_torch.py image.jpg model.ckpt          # inference
    python train_torch.py model.ckpt                    # inspect
    python train_torch.py data.yaml --compute-anchors   # k-means anchors
"""

import sys

from yolo_from_scratch_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
