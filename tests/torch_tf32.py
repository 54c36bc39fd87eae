"""The 3xTF32 arithmetic of the port's f32 attention kernels on the CPU, for
the tests that emulate them (``tests/test_torch_bwd_slices.py``: the
backward; ``tests/test_torch_fwd_slices.py``: the forward).
``csrc/tf32x3.cuh`` splits each f32 operand into hi = tf32(x) and lo = x -
hi, which the tensor core reads as TF32, and sums a k8 step's lo·hi, hi·lo
and hi·hi products in f32; accumulating products contract in the permuted
order in which an m16n8 accumulator is an A fragment. Imports neither jax
nor the reference.
"""
import torch


def bits_to_f32(b):
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(torch.float32)


def tf32(x):
    """The kernels' ``tf32_rna`` on the CPU: x rounded to TF32 (the top 10 of
    f32's 23 mantissa bits kept), to nearest with ties away from zero as
    ``cvt.rna.tf32.f32`` rounds, by adding half of the dropped 13 bits'
    weight to the int32 bits (carrying into the exponent where it must) and
    clearing them; inf stays inf. A NaN's bits may carry into the sign or
    lose the mantissa (the GPU's canonical NaN 0x7FFFFFFF gives -0): the
    split keeps NaN in lo (``tf32_read``). Returns f32 whose low 13 bits
    are 0."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits_to_f32((b + 0x1000) & 0xFFFFE000)


def tf32_read(x):
    """An f32 operand as the tensor core reads it as TF32: its top 19 bits,
    the low 13 mantissa bits dropped (truncated toward zero); a NaN whose
    top mantissa bits are set (the GPU's arithmetic gives 0x7FFFFFFF) stays
    NaN. The kernels hand lo = x - hi over so."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits_to_f32(b & 0xFFFFE000)


def mm3(a, b):
    """a @ b as the kernels' 3xTF32 products: a [..., M, K] and b [..., K, N]
    split into hi = tf32(x) and lo = x - hi as the tensor core reads it
    (NaN for a NaN x), then k8 step by k8 step the two small products
    (lo·hi, hi·lo) and hi·hi added to one f32 sum from zero (the S-type
    products over d; the accumulating products over keys or queries sum a
    tile's steps so and the caller adds the result to its running sum)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        x = slice(k0, k0 + 8)
        acc = acc + al[..., x] @ bh[..., x, :] + ah[..., x] @ bl[..., x, :] + ah[..., x] @ bh[..., x, :]
    return acc


def permuted(n):
    """The kernels' contraction order over n keys (queries) of accumulating
    products: within each 8-block k' = t -> 2t, t + 4 -> 2t + 1, so an
    m16n8 accumulator (columns 2t, 2t + 1 a thread) is an A fragment
    (k-columns t, t + 4) as it stands."""
    i = torch.arange(n)
    return (i // 8) * 8 + torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])[i % 8]
