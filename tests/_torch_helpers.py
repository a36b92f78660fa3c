"""Shared helpers of the PyTorch port's tests (``test_torch_*.py``).

Inputs are made from a seed with numpy and handed to both packages; the
port's tensors are int32 bit patterns of the same uint32 limbs.
"""

import numpy as np
import pytest
import torch

from ligero_prover_tpu_torch.field import bn254 as F

torch.set_num_threads(2)

# canonical edge values, and operands in [p, 2^256) for the Montgomery core
EDGES = [0, 1, 2, F.MODULUS - 1, F.MODULUS - 2, F.R % F.MODULUS,
         F.R * F.R % F.MODULUS, (F.MODULUS - 1) // 2]
NONCANONICAL = [F.MODULUS, F.MODULUS + 1, 2 * F.MODULUS, 1 << 255,
                (1 << 256) - 1]


def rand_limbs(gen, shape, canonical=True) -> np.ndarray:
    """Random (*shape, 8) uint32 limbs; canonical ones are below p."""
    arr = gen.integers(0, 2 ** 32, size=tuple(shape) + (8,),
                       dtype=np.uint64).astype(np.uint32)
    if canonical:
        arr[..., 7] %= F.MODULUS >> 224
    return arr


def to_t(arr, device=None) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr, np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_np(x) -> np.ndarray:
    return x.detach().cpu().contiguous().numpy().view(np.uint32)


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda", 0)
