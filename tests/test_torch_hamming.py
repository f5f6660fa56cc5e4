"""Port parity, the packed-bit Hamming distance matrix: the plain PyTorch
version of the Hopper kernel (`plslam_torch/ops/kernels/hamming.py`, the CPU
side of `csrc/hamming.cu`) against the Pallas kernel in interpret mode and
against the JAX package's reference popcount.

Tolerance: none — distances are integers and must be equal. Descriptors are
drawn as uint32 with numpy and handed to the port as the int32 tensors that
carry the same bits (the port's descriptor layout).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam.models.keyframe_db import hamming_matrix as j_hamming_ref
from plslam.ops.kernels.hamming import hamming_matrix_pallas
from plslam_torch.ops.kernels import hamming


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _as_port(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("n1,n2", [(150, 90), (64, 64)])
def test_hamming_plain_matches_pallas_and_reference(n1, n2):
    rng = np.random.default_rng(n1 + n2)
    a, b = _words(rng, n1), _words(rng, n2)
    # rows with every bit set or clear: the sign bit and the popcount extremes
    a[0], a[1], b[0] = 0xFFFFFFFF, 0, 0xFFFFFFFF
    pallas = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    ref = np.asarray(j_hamming_ref(jnp.asarray(a), jnp.asarray(b)))
    n0 = hamming.LAUNCHES
    out = hamming.hamming_matrix(_as_port(a), _as_port(b))  # CPU tensors: the plain version
    assert hamming.LAUNCHES == n0
    assert out.dtype == torch.int32 and out.shape == (n1, n2)
    assert torch.equal(out, hamming.hamming_matrix_torch(_as_port(a), _as_port(b)))
    np.testing.assert_array_equal(out.numpy(), pallas)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[0, 0] == 0 and out[1, 0] == 256


def test_popcount32_every_bit():
    """Each single bit, all bits, and words whose int32 view is negative."""
    words = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xAAAAAAAA, 0x0F0F0F0F]
                     + [1 << k for k in range(32)], np.uint32)
    x = torch.from_numpy(words.view(np.int32).astype(np.int64)) & 0xFFFFFFFF
    expect = [bin(int(w)).count("1") for w in words]
    assert hamming.popcount32(x).tolist() == expect


def test_hamming_wrapper_rejects_what_the_kernel_does_not_take():
    """The kernel's checks (run before any launch, so they hold on any host)
    and the dispatch: a tensor on neither the CPU nor CUDA raises."""
    with pytest.raises(ValueError, match="CUDA"):
        hamming.hamming_matrix_cuda(torch.zeros((4, 8), dtype=torch.int32),
                                    torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        hamming.hamming_matrix(torch.zeros((4, 8), dtype=torch.int32, device="meta"),
                               torch.zeros((4, 8), dtype=torch.int32, device="meta"))
