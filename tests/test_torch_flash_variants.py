"""The three flash_attention kernels of the port and the host-side rules
they share with it: which kernel takes which inputs, each kernel's tile
shape, its tile skip and its grid limits.

These are pure Python, so they run on the CPU.  ``visited_tiles`` is held
to a brute-force count from the oracle's mask (``ref.attention_ref``'s,
enumerated in numpy per (q tile, KV tile)) for every tile shape, over the
option sets of the cases that chip_smoke.py runs on the card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch import kernels
from repro_torch.kernels import attention as kattn

# (Tq, Tk, options): chip_smoke.py's FLASH_CASES, the prefix beyond one KV
# tile, the full-width shape, and a q tile that sees no key at all
MASK_CASES = [
    (16, 16, dict(causal=True)),
    (33, 33, dict(causal=True)),
    (64, 64, dict(causal=True, window=16)),
    (48, 48, dict(causal=True)),
    (40, 40, dict(causal=True, prefix_len=8)),
    (24, 24, dict(causal=False)),
    (384, 384, dict(causal=True, prefix_len=256)),
    (20, 50, dict(causal=True, q_offset=30)),
    (200, 200, dict(causal=True, window=70)),
    (130, 130, dict(causal=True)),
    (65, 97, dict(causal=False)),
    (70, 70, dict(causal=True, q_offset=5)),
    (300, 300, dict(causal=True)),
    (4096, 4096, dict(causal=True)),
    (300, 300, dict(causal=True, window=40, prefix_len=100)),
    (130, 90, dict(causal=True, window=8, q_offset=200)),
]


def _oracle_mask(Tq, Tk, causal=True, window=0, prefix_len=0, q_offset=0):
    """The visible (query, key) pairs of ``ref.attention_ref``."""
    qp = np.arange(Tq)[:, None] + q_offset
    kp = np.arange(Tk)[None, :]
    m = np.ones((Tq, Tk), bool)
    if causal:
        m = kp <= qp
    if window > 0:
        m = m & (kp > qp - window)
    if prefix_len > 0:
        m = m | (kp < prefix_len)
    return m


def _brute_visited(Tq, Tk, bq, bk, **kw):
    m = _oracle_mask(Tq, Tk, **kw)
    return sum(bool(m[q0:q0 + bq, k0:k0 + bk].any())
               for q0 in range(0, Tq, bq) for k0 in range(0, Tk, bk))


def test_oracle_mask_is_the_references():
    """The brute force's mask is the one attention_ref applies: a row of
    constant scores gives uniform weights over the visible keys."""
    Tq, Tk, kw = 12, 20, dict(causal=True, window=5, prefix_len=3,
                              q_offset=6)
    q = np.zeros((1, Tq, 1, 4), np.float32)
    k = np.zeros((1, Tk, 1, 4), np.float32)
    v = np.arange(Tk, dtype=np.float32)[None, :, None, None].repeat(4, -1)
    out = np.asarray(ref.attention_ref(*map(jnp.asarray, (q, k, v)), **kw))
    m = _oracle_mask(Tq, Tk, **kw)
    want = (m * np.arange(Tk)).sum(1) / m.sum(1)
    np.testing.assert_allclose(out[0, :, 0, 0], want, rtol=1e-6)


@pytest.mark.parametrize("tile", [(torch.float32, 128), (torch.bfloat16, 128),
                                  (torch.bfloat16, 256), (128, 64), (16, 128),
                                  (torch.bfloat16, 96)],
                         ids=["f32", "bf16_d128", "bf16_d256", "128x64",
                              "16x128", "bf16_d96"])
@pytest.mark.parametrize("Tq,Tk,kw", MASK_CASES)
def test_visited_tiles_equal_brute_force(Tq, Tk, kw, tile):
    """Each variant's tile shape (the wgmma kernel's at D = 128, the same
    at 64; the mma.sync kernel's at 96 and 256; the f32 kernel's), and two
    others the rule must also hold for."""
    if isinstance(tile[0], torch.dtype):
        tile = kattn.variant(*tile)[1:]
    bq, bk = tile
    got = kattn.visited_tiles(Tq, Tk, bq=bq, bk=bk, **kw)
    assert got == _brute_visited(Tq, Tk, bq, bk, **kw)


def test_visited_tiles_default_is_the_f32_tile():
    kw = dict(causal=True, window=70)
    assert kattn.visited_tiles(200, 200, **kw) == kattn.visited_tiles(
        200, 200, bq=kattn.BQ, bk=kattn.BK, **kw)
    assert kattn.variant(torch.float32, 64)[1:] == (kattn.BQ, kattn.BK)


def test_variant_by_dtype_and_head_dim():
    """bf16 at D = 64 and 128 goes to the wgmma kernel (128 q rows by
    128-key tiles), every other bf16 D to the mma.sync kernel, f32 to the
    CUDA-core kernel."""
    for D in range(1, 257):
        bf = kattn.variant(torch.bfloat16, D)
        if D in (64, 128):
            assert bf == ("wgmma", 128, 128) == kattn.WGMMA
        else:
            assert bf == ("mma", 64, 32) == kattn.MMA
        assert kattn.variant(torch.float32, D) == ("f32", 64, 32)
    for dtype in (torch.bfloat16, torch.float32):
        for D in (0, 257, 512):
            with pytest.raises(ValueError, match="D <= 256"):
                kattn.variant(dtype, D)
    with pytest.raises(TypeError, match="f32 or bf16"):
        kattn.variant(torch.float16, 64)


def test_bf16_launch_limits_at_the_boundary():
    """The mma.sync kernel's grid is (B * Hq, q tiles): 65535 q tiles of
    64 rows; B * Hq up to 2**31 - 1."""
    bf = torch.bfloat16
    kattn.check_launch_limits(1, 65535 * 64, 1, 1, 96, dtype=bf)
    kattn.check_launch_limits(1, 65535 * 64, 1, 1, 256, dtype=bf)
    kattn.check_launch_limits(2 ** 16, 1, 1, 2 ** 15 - 1, 8, dtype=bf)
    kattn.check_launch_limits(65535, 1, 1, 32, 96, dtype=bf)
    bad = ((1, 65535 * 64 + 1, 1, 1, 96), (1, 65535 * 64 + 1, 1, 1, 256),
           (2 ** 16, 1, 1, 2 ** 15, 8), (1, 1, 1, 1, 257), (1, 0, 1, 1, 8),
           (1, 1, 0, 1, 8))
    for args in bad:
        with pytest.raises(ValueError, match="ceil\\(Tq / "):
            kattn.check_launch_limits(*args, dtype=bf)
    with pytest.raises(ValueError, match="int32"):
        kattn.check_launch_limits(1, 1, 1, 1, 8, q_offset=2 ** 31 - 1,
                                  dtype=bf)
    # the f32 kernel keeps its own grid: B * Hq on the y axis
    with pytest.raises(ValueError, match="B \\* Hq <= 65535"):
        kattn.check_launch_limits(65535, 1, 1, 32, 128)


@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_launch_limits_at_the_boundary(D):
    """The wgmma kernel's grid is (B * Hq, q tiles): 65535 q tiles of 128
    rows, twice the mma.sync kernel's rows at the same grid; B * Hq up to
    2**31 - 1.  The mma.sync kernel named at the same D keeps its own."""
    bf = torch.bfloat16
    kattn.check_launch_limits(1, 65535 * 128, 1, 1, D, dtype=bf)
    kattn.check_launch_limits(2 ** 16, 1, 1, 2 ** 15 - 1, D, dtype=bf)
    for args in ((1, 65535 * 128 + 1, 1, 1, D), (2 ** 16, 1, 1, 2 ** 15, D)):
        with pytest.raises(ValueError, match="ceil\\(Tq / 128\\)"):
            kattn.check_launch_limits(*args, dtype=bf)
    with pytest.raises(ValueError, match="ceil\\(Tq / 64\\)"):
        kattn.check_launch_limits(1, 65535 * 64 + 1, 1, 1, D, dtype=bf,
                                  var=kattn.MMA)
    with pytest.raises(ValueError, match="int32"):
        kattn.check_launch_limits(1, 1, 1, 1, D, q_offset=2 ** 31 - 1,
                                  dtype=bf)


def test_launcher_refuses_what_its_kernel_does_not_take():
    """The private launcher checks the variant against the inputs before it
    builds anything: the wgmma kernel only at D = 64 and 128, bf16 kernels
    only on bf16, the f32 kernel only on f32."""
    q = torch.zeros(1, 8, 2, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D = 64 or 128"):
        kattn._launch(kattn.WGMMA, q, q, q)
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(TypeError, match="does not take"):
        kattn._launch(kattn.MMA, q, q, q)
    with pytest.raises(TypeError, match="does not take"):
        kattn._launch(kattn.variant(torch.bfloat16, 64), q, q, q)
    with pytest.raises(TypeError, match="does not take"):
        kattn._launch(kattn.variant(torch.float32, 64), q.bfloat16(),
                      q.bfloat16(), q.bfloat16())


def test_cpu_bf16_takes_the_plain_version():
    """On CPU tensors no bf16 D launches a kernel: the head dims of the
    mma.sync kernel (16) and of the wgmma kernel (64, 128) alike."""
    kernels.reset_launch_counts()
    rng = np.random.RandomState(0)
    for D in (16, 64, 128):
        q, k, v = (torch.from_numpy(rng.randn(1, 9, 2, D).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(3))
        got = kattn.flash_attention(q, k, v)
        want = kattn.flash_attention_plain(q, k, v)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert kernels.sub_launch_counts()["flash_attention_mma"] == 0
    assert kernels.sub_launch_counts()["flash_attention_wgmma"] == 0
    assert kernels.launch_counts()["flash_attention"] == 0
