"""The port's Philox4x32-10 normal generator (K3 and its plain version).

Held against Random123's published known answer, an independent numpy
uint64 Philox, its own stream contract (same key and counters -> same
numbers; disjoint counter ranges -> disjoint streams), and statistics at
n = 2^18 whose bounds are ~5 standard deviations of each statistic.
"""
import math

import numpy as np
import pytest
import torch

from careless_tpu_torch.ops.fused_elbo import (philox4x32_10,
                                               plain_prng_normal,
                                               prng_normal)

torch.set_num_threads(2)

M32 = np.uint64(0xFFFFFFFF)


def numpy_philox(counter: np.ndarray, seed: int):
    """Philox4x32-10 with uint64 products (independent of the port's
    16-bit split)."""
    c = [counter & M32, counter >> np.uint64(32),
         np.zeros_like(counter), np.zeros_like(counter)]
    k0, k1 = np.uint64(seed & 0xFFFFFFFF), np.uint64(seed >> 32)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & M32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & M32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & M32]
    return c


def test_known_answer():
    """Random123's kat_vectors: philox4x32 10 rounds, counter 0, key 0."""
    words = philox4x32_10(torch.zeros(1, dtype=torch.int64), 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8]


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF12345678, 2 ** 64 - 1])
def test_matches_numpy_philox(seed):
    rng = np.random.default_rng(seed % 1000)
    counter = rng.integers(0, 2 ** 62, 4096, dtype=np.int64)
    counter[:3] = [0, 2 ** 32 - 1, 2 ** 32]
    got = philox4x32_10(torch.tensor(counter), seed)
    want = numpy_philox(counter.astype(np.uint64), seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


def test_stream_contract():
    a = prng_normal(1000, 42, 0, "cpu")
    assert torch.equal(a, prng_normal(1000, 42, 0, "cpu"))
    # counters 0..1999 in one call == two calls over disjoint ranges
    both = prng_normal(2000, 42, 0, "cpu")
    assert torch.equal(both[:1000], a)
    assert torch.equal(both[1000:], prng_normal(1000, 42, 1000, "cpu"))
    # disjoint ranges, and other keys (step i uses key base | i << 32)
    _, bits_a = plain_prng_normal(1000, 42, 0, "cpu", with_bits=True)
    for seed, offset in ((42, 1000), (42 | 1 << 32, 0), (43, 0)):
        _, bits_b = plain_prng_normal(1000, seed, offset, "cpu",
                                      with_bits=True)
        assert not set(bits_a[:, 0].tolist()) & set(bits_b[:, 0].tolist())


def test_uniform_map_avoids_zero():
    """u = ((r >> 8) + 1) 2^-24 lies in (0, 1]: the largest |x| is
    sqrt(-2 log 2^-24) and no clamp spike appears."""
    x, bits = plain_prng_normal(1 << 16, 7, 0, "cpu", with_bits=True)
    assert torch.isfinite(x).all()
    assert x.abs().max() <= math.sqrt(-2 * math.log(2.0 ** -24))
    r0 = bits[:, 0].to(torch.int64) & 0xFFFFFFFF
    u1 = ((r0 >> 8) + 1).double() * 2.0 ** -24
    torch.testing.assert_close(
        x.double(), torch.sqrt(-2 * torch.log(u1)) * torch.cos(
            2 * math.pi * (((bits[:, 1].to(torch.int64) & 0xFFFFFFFF) >> 8)
                           + 1).double() * 2.0 ** -24),
        rtol=0, atol=2e-5)


def test_statistics():
    n = 1 << 18
    x = prng_normal(n, 20241016, 0, "cpu").double()
    assert abs(x.mean().item()) < 5 / math.sqrt(n)
    assert abs(x.var().item() - 1) < 5 * math.sqrt(2 / n)
    for k in (3, 4, 5):
        p = math.erfc(k / math.sqrt(2))
        count = int((x.abs() > k).sum())
        assert abs(count - n * p) <= 5 * math.sqrt(n * p * (1 - p)) + 1, k
    edges = torch.special.ndtri(torch.arange(1, 64, dtype=torch.float64) / 64)
    counts = torch.bincount(torch.bucketize(x, edges), minlength=64).double()
    chi2 = float(((counts - n / 64) ** 2 / (n / 64)).sum())
    assert chi2 < 63 + 5 * math.sqrt(2 * 63), chi2


def test_philox_launcher_refuses_the_cpu():
    from careless_tpu_torch import kernels
    with pytest.raises(ValueError, match="CUDA"):
        kernels.philox_normal(8, 1, 0, torch.device("cpu"))
