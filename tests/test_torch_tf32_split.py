"""The 3xTF32 split of the port's f32 kernels, modelled in torch on the CPU.

The f32 GEMM (csrc/gemm_f32.cu) and the f32 attention core
(csrc/attention_f32.cu) run their products on the TF32 tensor cores as three
products of split operands: x = hi + lo, hi = tf32(x), lo = tf32(x - hi),
each rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``:
common.cuh ``split_tf32``), and the products lo.hi + hi.lo + hi.hi summed in
f32. A TF32 value keeps 10 fraction bits, so hi.hi, hi.lo and lo.hi are exact
in f32; ``product_3x`` sums them with torch's f32 matmuls, which round to
nearest. The tensor core does not: it truncates as it accumulates, so
``product_tc`` models that apart, as the mildest truncation there is (each
m16n8k8 step's 8 products and the accumulator summed exactly, the sum cut
toward zero to f32).

Here: the bit model of the rounding on chosen values, then the split product
at K = 1024, 3072 and 4096 (the ViT-L contraction widths: fc1 and the qkv
projection, the qkv output, fc2) at the operand scales of ``chip_smoke.py``'s
f32 rows (activations N(0, 1), weights of std K^-1/2), held to the f64
product and to the exact f32 product at the card's tolerance for the f32
forms (relative RMS 1e-5); one TF32 pass, which misses that tolerance; and
the truncating accumulator, under which folding all of K into one
accumulator misses it where summing each 32-wide stage apart (as both
kernels do) meets it.
"""

import numpy as np
import pytest
import torch

from torch_threads import torch_threads  # noqa: F401

CARD_TOL = 1e-5   # each f32 form against its plain version on the card


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an f32 tensor: the low 13 of its 23 fraction bits
    rounded off, to nearest, ties away from zero (adding half of the dropped
    unit to the magnitude bits, then clearing them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product_3x(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) . b (N, K)^T as the kernels form it: lo.hi, hi.lo, hi.hi,
    each summed in f32, added in f32 in that order."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def trunc_f32(v: torch.Tensor) -> torch.Tensor:
    """f64 to f32, rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def product_tc(a: torch.Tensor, b: torch.Tensor, stage: int) -> torch.Tensor:
    """``product_3x`` with the tensor core's truncating accumulator: each
    ``stage`` of K summed from zero, k = 8 at a time (lo.hi, hi.lo, hi.hi,
    each step's 8 products and the accumulator summed exactly and cut toward
    zero to f32), the stages' partials added in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    passes = [(x.double(), y.double()) for x, y in ((al, bh), (ah, bl),
                                                    (ah, bh))]
    total = torch.zeros(a.shape[0], b.shape[0])
    for s in range(0, a.shape[1], stage):
        acc = torch.zeros_like(total)
        for k in range(s, s + stage, 8):
            for x, y in passes:
                acc = trunc_f32(acc.double()
                                + x[:, k:k + 8] @ y[:, k:k + 8].T)
        total = total + acc
    return total


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("value,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),           # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),           # under the tie: down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),         # a tie between odd units
    (2.0 - 2.0 ** -23, 2.0),                         # carries into the exponent
    (-0.0, -0.0)])
def test_tf32_rna_bit_model(value, want):
    x = torch.tensor([value], dtype=torch.float32)
    got = tf32_rna(x)
    assert got.view(torch.int32).item() == \
        torch.tensor([want], dtype=torch.float32).view(torch.int32).item()


def test_split_is_exact_to_2_pow_22():
    """hi has 11 significant bits; x - hi is exact in f32; hi + lo is x to
    2^-22 of |x| (lo's own rounding), hi alone only to 2^-11."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.normal(size=100_000)
                          * 10.0 ** rng.integers(-6, 6, 100_000))
                         .astype(np.float32))
    hi, lo = split(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert (lo.view(torch.int32) & 0x1FFF == 0).all()
    xd = x.double()
    assert ((xd - hi.double()).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((xd - hi.double() - lo.double()).abs()
            <= 2.0 ** -22 * xd.abs()).all()


@pytest.mark.parametrize("K", [1024, 3072, 4096])
def test_split_product_holds_f32(K):
    """The 3xTF32 product against f64 (under 1e-6 relative RMS, as the exact
    f32 product is) and against the exact f32 product at the card's 1e-5;
    one TF32 pass misses the card's tolerance."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.normal(size=(16, K)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(32, K)) * K ** -0.5)
                         .astype(np.float32))
    exact64 = a.double() @ b.double().T
    exact32 = a @ b.T
    three = product_3x(a, b)
    one = tf32_rna(a) @ tf32_rna(b).T
    assert three.dtype == torch.float32
    e3_64, e32_64 = _rel(three, exact64), _rel(exact32, exact64)
    assert e3_64 <= 1e-6 and e32_64 <= 1e-6, (e3_64, e32_64)
    e3 = _rel(three, exact32)
    assert e3 <= CARD_TOL / 10, e3
    e1 = _rel(one, exact32)
    assert e1 > CARD_TOL, e1


@pytest.mark.parametrize("K", [1024, 3072, 4096])
def test_truncating_accumulator_needs_stage_partials(K):
    """Under a truncating accumulator, each 32-wide stage summed apart stays
    under a tenth of the card's tolerance; all of K folded into one
    accumulator reads over ten times that, past the tolerance from K = 3072.
    A build of the kernels that folded every product into one accumulator
    missed the tolerance on the card at row 1's front half (1.4e-5: the qkv
    projection at K = 1024, then the core) and at row 4 (K = 1024, then
    4096), which this model bears out."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.normal(size=(16, K)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(32, K)) * K ** -0.5)
                         .astype(np.float32))
    exact32 = a @ b.T
    staged = _rel(product_tc(a, b, 32), exact32)
    folded = _rel(product_tc(a, b, K), exact32)
    assert staged <= CARD_TOL / 10, staged
    assert folded > 10 * staged, (folded, staged)
    if K >= 3072:
        assert folded > CARD_TOL, folded
