"""The port's Philox4x32-10 normal generator (K3 and its plain version).

Held against Random123's published known answer, an independent numpy
uint64 Philox and the map from index to normal built on it (four normals
per Philox block), its own stream contract (same key and indices -> same
numbers; disjoint index ranges -> disjoint streams; a call split anywhere
-> the same stream), and statistics whose bounds are ~4-5 standard
deviations of each statistic.
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


def _words_and_trig(bits, slot):
    """u1 = u(ra), and cos or sin of 2 pi u(rb) by slot, in f64."""
    ra = bits[:, 0].to(torch.int64) & 0xFFFFFFFF
    rb = bits[:, 1].to(torch.int64) & 0xFFFFFFFF
    u1 = ((ra >> 8) + 1).double() * 2.0 ** -24
    angle = 2 * math.pi * ((rb >> 8) + 1).double() * 2.0 ** -24
    return u1, torch.where(slot % 2 == 1, torch.sin(angle), torch.cos(angle))


def test_uniform_map_avoids_zero():
    """u = ((r >> 8) + 1) 2^-24 lies in (0, 1]: the largest |x| is
    sqrt(-2 log 2^-24) and no clamp spike appears."""
    x, bits = plain_prng_normal(1 << 16, 7, 0, "cpu", with_bits=True)
    assert torch.isfinite(x).all()
    assert x.abs().max() <= math.sqrt(-2 * math.log(2.0 ** -24))
    u1, trig = _words_and_trig(bits, torch.arange(1 << 16) % 4)
    torch.testing.assert_close(x.double(), torch.sqrt(-2 * torch.log(u1))
                               * trig, rtol=0, atol=2e-5)


@pytest.mark.parametrize("seed,offset", [(3, 0), (0xDEADBEEF12345678, 1001),
                                         (2 ** 64 - 1, 2 ** 34 + 3)])
def test_four_normals_per_philox_block(seed, offset):
    """Index e takes slot e & 3 of Philox block e >> 2 (numpy_philox, an
    independent Philox): slots 0 and 1 are R(r0) cos and sin of
    2 pi u(r1), slots 2 and 3 the same of (r2, r3); words exact, normals
    within 2e-5 of a float32 numpy Box-Muller."""
    n = 4099
    x, bits = plain_prng_normal(n, seed, offset, "cpu", with_bits=True)
    e = offset + np.arange(n, dtype=np.uint64)
    r = numpy_philox(e >> np.uint64(2), seed)
    slot = (e & np.uint64(3)).astype(np.int64)
    for s in range(4):
        at = slot == s
        ra, rb = (r[0], r[1]) if s < 2 else (r[2], r[3])
        got = bits[torch.from_numpy(at)].numpy().astype(np.int64) \
            & 0xFFFFFFFF
        np.testing.assert_array_equal(got[:, 0], ra[at].astype(np.int64))
        np.testing.assert_array_equal(got[:, 1], rb[at].astype(np.int64))
        u1 = ((ra[at] >> np.uint64(8)) + np.uint64(1)).astype(np.float32) \
            * np.float32(2.0 ** -24)
        u2 = ((rb[at] >> np.uint64(8)) + np.uint64(1)).astype(np.float32) \
            * np.float32(2.0 ** -24)
        angle = np.float32(2 * np.pi) * u2
        trig = np.sin(angle) if s % 2 else np.cos(angle)
        want = np.sqrt(np.float32(-2.0) * np.log(u1)) * trig
        np.testing.assert_allclose(x.numpy()[at], want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("first,cut", [(1001, 1003), (1003, 1009),
                                       (2 ** 33 + 1, 2 ** 33 + 6)])
def test_stream_splits_at_unaligned_offsets(first, cut):
    """A call split in two at any index gives the same stream, also where
    the offsets are not multiples of 4 (a Philox block shared by both)."""
    n = 2001
    whole, bits = plain_prng_normal(n, 11, first, "cpu", with_bits=True)
    head, bits_h = plain_prng_normal(cut - first, 11, first, "cpu",
                                     with_bits=True)
    tail, bits_t = plain_prng_normal(n - (cut - first), 11, cut, "cpu",
                                     with_bits=True)
    assert torch.equal(whole, torch.cat([head, tail]))
    assert torch.equal(bits, torch.cat([bits_h, bits_t]))
    assert torch.equal(whole, prng_normal(n, 11, first, "cpu"))


@pytest.mark.parametrize("pair", [0, 1])
def test_cos_sin_pairs_uncorrelated(pair):
    """The two normals of one Box-Muller pair (slots 0 and 1, or 2 and 3)
    have a correlation within 4 / sqrt(n) of 0."""
    x = prng_normal(1 << 20, 97, 0, "cpu").double().view(-1, 4)
    a, b = x[:, 2 * pair], x[:, 2 * pair + 1]
    n = a.numel()
    corr = ((a - a.mean()) * (b - b.mean())).mean() / (a.std() * b.std())
    assert abs(corr.item()) < 4 / math.sqrt(n), corr.item()


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
