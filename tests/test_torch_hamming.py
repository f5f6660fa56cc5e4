"""Port parity, the packed-bit Hamming distance matrix: the plain PyTorch
version of the Hopper kernel (`plslam_torch/ops/kernels/hamming.py`, the CPU
side of `csrc/hamming.cu`) against the Pallas kernel in interpret mode and
against the JAX package's reference popcount; the identity the kernel
computes with the tensor cores (popcount of the AND); and the two PyTorch
library calls that `chip_smoke.py` times beside the kernel.

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
from plslam_torch.utils.measure import hamming_library_calls


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _as_port(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("n1,n2", [(150, 90), (64, 64), (128, 256)])
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


# each single bit, all bits, and words whose int32 view is negative
EXTREME_WORDS = ([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xAAAAAAAA, 0x0F0F0F0F]
                 + [1 << k for k in range(32)])


@pytest.mark.parametrize("n1,n2", [(64, 64), (128, 256)])
def test_hamming_library_forms_match_reference(n1, n2):
    """The yardstick computes the same function: `torch.matmul` of ±1
    float16 signs ((256 − M)/2; the form the card times) and
    `torch.cdist(p=0)` of 0/1 bits equal JAX's `hamming_matrix`, extreme
    rows included."""
    rng = np.random.default_rng(7 * n1 + n2)
    a, b = _words(rng, n1), _words(rng, n2)
    a[0], a[1], b[0], b[1] = 0xFFFFFFFF, 0, 0xFFFFFFFF, a[2]
    ref = np.asarray(j_hamming_ref(jnp.asarray(a), jnp.asarray(b)))
    assert ref[0, 0] == 0 and ref[1, 0] == 256 and ref[2, 1] == 0
    calls = hamming_library_calls(_as_port(a), _as_port(b))
    assert len(calls) == 2
    for name, (call, decode) in calls.items():
        out = decode(call())
        assert out.dtype == torch.int32, name
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=name)


def test_and_popcount_identity():
    """popcount(a ^ b) = popcount(a) + popcount(b) − 2 popcount(a & b), the
    identity the kernel's 1-bit MMA (AND + popc) computes, over random
    words and every pair of the extreme words."""
    rng = np.random.default_rng(3)
    ext = np.array(EXTREME_WORDS, np.uint32)
    a = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint32), np.repeat(ext, len(ext))])
    b = np.concatenate([rng.integers(0, 2 ** 32, 4096, dtype=np.uint32), np.tile(ext, len(ext))])
    x, y = (torch.from_numpy(w.view(np.int32).astype(np.int64)) & 0xFFFFFFFF for w in (a, b))
    pc = hamming.popcount32
    assert torch.equal(pc(x) + pc(y) - 2 * pc(x & y), pc(x ^ y))
    assert pc(x ^ y).tolist() == [bin(int(u) ^ int(v)).count("1") for u, v in zip(a, b)]


def test_popcount32_every_bit():
    """Each single bit, all bits, and words whose int32 view is negative."""
    words = np.array(EXTREME_WORDS, np.uint32)
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
