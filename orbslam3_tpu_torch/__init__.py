"""orbslam3_tpu_torch — the PyTorch + CUDA port of `orbslam3_tpu`.

The JAX package `orbslam3_tpu` stays the reference; this package mirrors its
layout module by module (`ops/`, `optim/`, `atlas/`, `pipeline/`, `io/`,
`viz/`, `config.py`) and runs the same functions on torch tensors; its
commands are `python -m orbslam3_tpu_torch.run_sequence` and
`python -m orbslam3_tpu_torch.serve_stream`. The two Pallas kernels of the reference
are hand-written CUDA kernels here (`csrc/`, built at first use by
`ops/_build.py`); on CPU tensors their wrappers run plain PyTorch versions.

The package never imports `jax` or `orbslam3_tpu`: state crosses over as
numpy arrays (`convert.py`). Nor OpenCV or PyYAML: `io/png.py` and
`config.py` read PNGs and settings files.

Precision: TF32 is switched off for float32 matmuls and convolutions, here at
import. The pose solve's normal equations, the local BA's reduced camera
system and the pyramid resize run as float32 matmuls; TF32 keeps about three
decimal digits, which made the reference's reduced camera systems indefinite
when its TPU matmuls ran at reduced precision. The port does not depend on PyTorch's defaults for this.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
