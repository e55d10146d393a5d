"""Kernels 4 and 5: the offline-enhancement tail on Hopper
(``csrc/enhance.cu``) and their plain twins.

``soft_mask_cuda`` replaces ``gccnmf_tpu/ops/enhance_pallas.py::
soft_mask_pallas``: for every frame and atom, the TDOA whose steering-folded
dictionary column scores highest against the PHAT coherence, then a
generalized-Gaussian mask around the utterance's target TDOA. The
(B, T, D, K) scores never reach device memory: each block keeps a running
(max, argmax) in registers while it loops over the TDOAs. The products
bound it: in float32 the least work is 2·B·T·F·D·K + 3·B·T·F·D flop (form
``Re c·cos_d + Im c·sin_d``, then one GEMM against W); in bf16, where the
folded product ``cos_d·W`` is rounded, 4·B·T·F·D·K (669 GFLOP at 16 × 10 s
with D = K = 128). In the bf16 mode the scores run on the tensor cores
(``wgmma``, ``csrc/scores.cu``) as one 2F-deep product per TDOA, between
the coherence rows ``[Re c | Im c]`` (packed by the kernel, as
:func:`synthesis_cuda.idft_rows` lays them out) and the fold ``[cw[d]; sw[d]]``
(:func:`fold_rows`, built once with the basis), both bf16 on zero-padded
128-byte rows (:func:`score_row_pad`), two TDOAs a block and two row tiles
a cluster sharing the fold's copies. In float32 they stay fp32 FMAs on the
SIMT cores, since no tensor-core path is exact fp32, on the pipelined core of
``csrc/simt_gemm.cuh``: the same 2F-deep product per TDOA, between the
coherence rows packed in fp32 and the fp32 ``cw``/``sw`` as they lie. That
keeps JAX's function, ``mm(Re c, cw[d]) + mm(Im c, sw[d])``, and its
4·B·T·F·D·K flop, which bound it at the card's fp32 FMA rate (1.25 ms at
B = 2 of 10 s, D = K = 128).

``tf_synthesis_cuda`` replaces ``::tf_synthesis_pallas``: the Wiener TF mask
``h_mask·(W/Σ_k W)ᵀ`` multiplied into both channels' planes, then the
windowed, gained iDFT, overlap-add and window/2 center trim that the
separation synthesis uses (``csrc/istft.cuh``; in the bf16 mode the iDFT on
the tensor cores over the spectrum rows of every utterance and channel,
against the basis rows of :func:`synthesis_cuda.synthesis_basis`; in
float32 the hand-written FFT of its ``plan`` and ``twiddle``). Its
result equals
``istft(wiener_tf_mask(W, h_mask) ⊙ X, conjugate=True, center_trim=True)
· gain``: (B, C, (T-1)·hop) fp32.

``enhance_synthesis_cuda`` chains the two, as ``enhance_synthesis_pallas``
does. One difference between the JAX package's two backends is kept on
purpose: the kernels (and :func:`soft_mask_plain`) pin distance 0 to a mask
of 1, as the Pallas kernel does, while ``masks.soft_tdoa_coefficient_mask``
takes ``0**β`` literally; the two differ only at β = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gccnmf_torch import _build
from gccnmf_torch.ops import masks
from gccnmf_torch.ops.nmf_cuda import row_pad
from gccnmf_torch.ops.synthesis_cuda import (
    check_idft_basis, idft_args, istft_plain, synthesis_basis,
)
from gccnmf_torch.precision import bf16_operands, round_bf16

__all__ = [
    "SoftMaskBasis",
    "soft_mask_basis",
    "fold_rows",
    "score_row_pad",
    "soft_mask_cuda",
    "soft_mask_plain",
    "tdoa_argmax_plain",
    "argmax_flips",
    "TfSynthesisBasis",
    "tf_synthesis_basis",
    "wiener_spectra_plain",
    "tf_synthesis_cuda",
    "tf_synthesis_plain",
    "enhance_synthesis_cuda",
]

_TINY = 1e-30


class SoftMaskBasis(NamedTuple):
    """The steering-folded dictionary of :func:`soft_mask_basis`: ``cw``,
    ``sw`` (D, F, K), and in the bf16 mode ``fold``, the same values in the
    tensor-core layout of :func:`fold_rows` (None in float32)."""

    cw: torch.Tensor
    sw: torch.Tensor
    fold: torch.Tensor | None


def soft_mask_basis(cos_m, sin_m, w, matmul_dtype: str = "bfloat16",
                    device=None) -> SoftMaskBasis:
    """The steering-folded dictionary: ``cw[d,f,k] = cos[f,d]·W[f,k]`` and
    ``sw`` likewise, folded in fp32 and stored once in bf16 when
    ``matmul_dtype="bfloat16"`` (where JAX's ``make_mm`` rounds the folded
    product, never ``bf16(cos)·bf16(W)``), with the kernel's ``fold``."""
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    f, k = w.shape
    bf16 = bf16_operands(matmul_dtype)
    store = torch.bfloat16 if bf16 else torch.float32
    cw, sw = (m.reshape(f, -1, k).transpose(0, 1).to(store).contiguous()
              for m in masks.fold_steering_dictionary(cos_m, sin_m, w))
    return SoftMaskBasis(cw, sw, fold_rows(cw, sw) if bf16 else None)


def score_row_pad(n: int) -> int:
    """``n`` rounded up to a multiple of 64: bf16 rows of whole 128-byte
    lines, the row stride of the tensor-core scores' operands, so that each
    row of a TMA box is one aligned line (rows of :func:`row_pad` length,
    2,064 bytes at F = 513, straddle two lines a box row and ran the
    kernel 15 % slower at the enhancement cell's shape)."""
    return -(-n // 64) * 64


def fold_rows(cw, sw):
    """The fold as the tensor-core kernel's B operand: (D, K, J) in the
    dtype of ``cw``, row (d, k) = ``[cw[d, :, k] | sw[d, :, k] | 0]`` with
    J = :func:`score_row_pad` ``(2F)``, so that the score of TDOA d is
    ``rows @ fold_rows(cw, sw)[d].T`` for the coherence rows
    ``idft_rows(coh_re, coh_im, F)`` zero-padded to J."""
    d, f, k = cw.shape
    out = torch.zeros((d, k, score_row_pad(2 * f)), device=cw.device, dtype=cw.dtype)
    out[..., :f] = cw.transpose(1, 2)
    out[..., f : 2 * f] = sw.transpose(1, 2)
    return out


def _mask_params(target_index, target_epsilon, target_beta, noise_floor, b, device):
    """(B, 4) fp32: target, ε, β, floor per utterance (scalars broadcast)."""
    cols = [torch.as_tensor(x, device=device).to(torch.float32).reshape(-1).expand(b)
            for x in (target_index, target_epsilon, target_beta, noise_floor)]
    return torch.stack(cols, dim=-1).contiguous()


def _apply_mask(arg, params, t):
    """The Pallas kernel's mask: ``exp(−p)/(1 + floor) + floor`` with
    ``p = exp(β·log(dist))`` and ``p = 0`` at distance 0."""
    p = params.repeat_interleave(t, dim=0)[:, None, :]  # (B·T, 1, 4)
    dist = torch.abs(arg.to(torch.float32) - p[..., 0]) / p[..., 1]
    pw = torch.where(dist > 0.0, torch.exp(p[..., 2] * torch.log(torch.clamp(dist, min=_TINY))),
                     0.0)
    return torch.exp(-pw) / (1.0 + p[..., 3]) + p[..., 3]


def tdoa_argmax_plain(coh_re, coh_im, basis, *, matmul_dtype="bfloat16", chunk_d=16):
    """The first step of :func:`soft_mask_plain`: for every row m = b·T + t
    and atom k, the largest score over the TDOAs and its index, ``(best
    (B·T, K) fp32, argmax (B·T, K) int64)``. The scores are built
    ``chunk_d`` TDOAs at a time and folded into the running (max, argmax)
    with a strict ``>``, so the first maximum wins and NaN never does."""
    r = round_bf16 if bf16_operands(matmul_dtype) else (lambda x: x)
    cw, sw = basis[:2]
    d, f, k = cw.shape
    cre = r(coh_re[..., :f].to(torch.float32)).reshape(-1, f)
    cim = r(coh_im[..., :f].to(torch.float32)).reshape(-1, f)
    best = torch.full((cre.shape[0], k), -torch.inf, device=cre.device)
    arg = torch.zeros((cre.shape[0], k), dtype=torch.int64, device=cre.device)
    for d0 in range(0, d, chunk_d):
        fold = [r(m[d0 : d0 + chunk_d].to(torch.float32)).permute(1, 0, 2).reshape(f, -1)
                for m in (cw, sw)]  # (F, dc·K)
        s = (cre @ fold[0] + cim @ fold[1]).reshape(cre.shape[0], -1, k)
        s = torch.where(torch.isnan(s), -torch.inf, s)
        top, at = s.max(dim=1)  # the first maximum within the chunk
        upd = top > best
        best = torch.where(upd, top, best)
        arg = torch.where(upd, at + d0, arg)
    return best, arg


def soft_mask_plain(coh_re, coh_im, basis, target_index, target_epsilon, target_beta,
                    noise_floor, *, matmul_dtype="bfloat16", chunk_d=16, return_argmax=False):
    """Plain torch version of :func:`soft_mask_cuda`:
    :func:`tdoa_argmax_plain`, then the mask."""
    b, t = coh_re.shape[:2]
    _, arg = tdoa_argmax_plain(coh_re, coh_im, basis, matmul_dtype=matmul_dtype,
                               chunk_d=chunk_d)
    params = _mask_params(target_index, target_epsilon, target_beta, noise_floor, b,
                          arg.device)
    mask = _apply_mask(arg, params, t).reshape(b, t, -1)
    if return_argmax:
        return mask, arg.to(torch.int32).reshape(b, t, -1)
    return mask


def argmax_flips(coh_re, coh_im, basis, kernel_argmax, *, matmul_dtype="bfloat16"):
    """Where a kernel's argmax-TDOA (B, T, K) differs from
    :func:`tdoa_argmax_plain`'s, and how near a tie each such flip was:
    ``(flipped (B, T, K) bool, gap, scale)``. ``gap`` is the largest
    distance from the plain maximum to the plain score at the kernel's TDOA
    over the flipped entries (0 without any), ``scale`` the largest finite
    |plain maximum|. The two sum in different orders, so a flip is right
    only where ``gap`` is within rounding of ``scale``."""
    r = round_bf16 if bf16_operands(matmul_dtype) else (lambda x: x)
    best, arg = tdoa_argmax_plain(coh_re, coh_im, basis, matmul_dtype=matmul_dtype)
    got = kernel_argmax.reshape(arg.shape).to(arg.device, torch.int64)
    flipped = got != arg
    scale = float(best[torch.isfinite(best)].abs().max())
    gap = 0.0
    if bool(flipped.any()):
        rows, atoms = flipped.nonzero(as_tuple=True)
        cw, sw = basis[:2]
        f = cw.shape[1]
        at_kernel = 0.0
        for plane, fold in ((coh_re, cw), (coh_im, sw)):
            c = r(plane[..., :f].to(torch.float32)).reshape(-1, f)[rows]  # (n, F)
            at_kernel = at_kernel + (c * r(fold[got[rows, atoms], :, atoms].float())).sum(-1)
        gap = float((best[rows, atoms] - at_kernel).abs().max())
    return flipped.reshape(kernel_argmax.shape), gap, scale


# both score kernels keep their argmax as a byte a TDOA chunk
_MAX_CHUNK = 256


def _full_wave(blocks, slots):
    """Whether the last wave of ``blocks`` over ``slots`` is >= 90 % full."""
    return blocks >= 0.9 * slots * -(-blocks // slots)


def _tdoa_chunk(m, k, d, sms, tensor_cores):
    """TDOAs a block scans: split over blocks when the (rows × atoms) tiles
    alone would leave the card's SMs idle (one or two utterances). Each
    takes the fewest splits whose last wave is at least 90 % full. The
    SIMT tile (128 rows × 64 atoms, float32) runs three blocks an SM, over
    TDOAs one at a time. The tensor-core tile (128 rows × 128 atoms × a TDOA
    pair) runs one block an SM over whole pairs (an even chunk, or all D
    TDOAs), its row tiles rounded up to clusters of two (an odd count's
    last block has no rows, but takes an SM all the same)."""
    if tensor_cores:
        tiles, slots, step = -(-m // 256) * 2 * -(-k // 128), sms, 2
    else:
        tiles, slots, step = -(-m // 128) * -(-k // 64), 3 * sms, 1
    units = -(-d // step)  # TDOAs, or TDOA pairs
    splits = next((s for s in range(1, units + 1) if _full_wave(tiles * s, slots)), units)
    return min(_MAX_CHUNK, d, -(-units // splits) * step)


def soft_mask_cuda(coh_re, coh_im, basis, target_index, target_epsilon, target_beta,
                   noise_floor, *, matmul_dtype="bfloat16", return_argmax=False,
                   tdoa_chunk=None):
    """Per-(frame, atom) soft target mask ``(B, T, K)`` fp32.

    ``coh_re``/``coh_im``: (B, T, Fp) fp32 or bf16 coherence planes,
    ``Fp >= F``; ``basis``: from :func:`soft_mask_basis` in the same
    ``matmul_dtype``; ``target_index`` (B,) and
    ``target_epsilon``/``target_beta``/``noise_floor`` (scalars or (B,)).
    ``matmul_dtype="bfloat16"`` rounds the GEMM operands to bf16 and runs
    the scores on the tensor cores. ``return_argmax=True`` also returns the
    (B, T, K) int32 argmax-TDOA. ``tdoa_chunk`` is the number of TDOAs one
    block scans (at most 256); ``None`` splits them across blocks
    when the frames alone would leave SMs idle. Any chunk gives the same
    result. Launches the CUDA kernel for CUDA planes; CPU planes take
    :func:`soft_mask_plain`. ``soft_mask_cuda.launches`` counts its calls,
    not the device kernels each one launches; ``soft_mask_cuda.multicast``
    the bf16 calls, whose scores run in clusters of two row tiles that
    share the fold's copies (TMA multicast)."""
    rnd = bf16_operands(matmul_dtype)
    if coh_re.device.type == "cpu":
        return soft_mask_plain(coh_re, coh_im, basis, target_index, target_epsilon,
                               target_beta, noise_floor, matmul_dtype=matmul_dtype,
                               return_argmax=return_argmax)
    cw, sw, fold = basis
    dev = _build.require_cuda("soft_mask_cuda", coh_re, coh_im, cw, sw)
    b, t, ldf = coh_re.shape
    d, f, k = cw.shape
    if coh_im.shape != coh_re.shape or coh_im.dtype != coh_re.dtype:
        raise ValueError("soft_mask_cuda: coherence planes disagree")
    if coh_re.dtype not in (torch.float32, torch.bfloat16) or ldf < f:
        raise ValueError("soft_mask_cuda: planes must be fp32/bf16 with >= F bins")
    if sw.shape != cw.shape or sw.dtype != cw.dtype:
        raise ValueError("soft_mask_cuda: folded dictionary halves disagree")
    ldj = score_row_pad(2 * f) if rnd else row_pad(2 * f)
    # (cw, sw, fold, rows scratch): the SIMT kernel reads cw, sw and fp32
    # rows, the tensor-core kernel the fold and bf16 rows
    if rnd:
        if fold is None or fold.shape != (d, k, ldj) or fold.dtype != torch.bfloat16:
            raise ValueError("soft_mask_cuda: matmul_dtype bfloat16 needs the (D, K, "
                             "score_row_pad(2F)) bf16 fold of soft_mask_basis(..., 'bfloat16')")
        _build.require_cuda("soft_mask_cuda", coh_re, fold)
        dicts = (None, None, fold.contiguous(),
                 torch.empty((b * t, ldj), device=dev, dtype=torch.bfloat16))
    elif cw.dtype != torch.float32:
        raise ValueError("soft_mask_cuda: matmul_dtype float32 needs a float32 folded dictionary")
    else:
        dicts = (cw.contiguous(), sw.contiguous(), None,
                 torch.empty((b * t, ldj), device=dev, dtype=torch.float32))
    cre, cim = coh_re.contiguous(), coh_im.contiguous()
    params = _mask_params(target_index, target_epsilon, target_beta, noise_floor, b, dev)
    m = b * t
    if tdoa_chunk is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        chunk = _tdoa_chunk(m, k, d, sms, rnd)
    else:
        chunk = min(tdoa_chunk, _MAX_CHUNK)
    splits = -(-d // chunk)
    pmax = torch.empty((splits, m, k), device=dev, dtype=torch.float32)
    parg = torch.empty((splits, m, k), device=dev, dtype=torch.int32)
    out = torch.empty((b, t, k), device=dev, dtype=torch.float32)
    arg = torch.empty((b, t, k), device=dev, dtype=torch.int32) if return_argmax else None
    _build.launch(
        "gccnmf_soft_mask", dev,
        cre.data_ptr(), cim.data_ptr(), int(cre.dtype == torch.bfloat16), ldf,
        *(0 if x is None else x.data_ptr() for x in dicts), ldj, params.data_ptr(),
        pmax.data_ptr(), parg.data_ptr(), out.data_ptr(), 0 if arg is None else arg.data_ptr(),
        b, t, f, k, d, splits, chunk,
    )
    soft_mask_cuda.launches += 1
    soft_mask_cuda.multicast += int(rnd)
    return (out, arg) if return_argmax else out


soft_mask_cuda.launches = 0
soft_mask_cuda.multicast = 0


class TfSynthesisBasis(NamedTuple):
    """The Wiener synthesis's constants (:func:`tf_synthesis_basis`): the
    normalized dictionary ``wn`` (K, F) fp32, then the fields of
    :func:`synthesis_cuda.synthesis_basis` (``a``, ``b_neg``, ``rows`` in
    the bf16 mode, else None, and the float32 FFT's ``scale``, ``twiddle``
    and ``plan``), so that ``basis[1:]`` is the iDFT's basis."""

    wn: torch.Tensor
    a: torch.Tensor
    b_neg: torch.Tensor
    rows: torch.Tensor | None
    scale: torch.Tensor
    twiddle: torch.Tensor
    plan: torch.Tensor


def tf_synthesis_basis(w, window, gain: float, matmul_dtype: str = "bfloat16",
                       device=None) -> TfSynthesisBasis:
    """The normalized dictionary ``Wn = (W/Σ_k W)ᵀ`` (K, F) and the iDFT
    basis with synthesis window and gain folded in, built once for
    ``matmul_dtype`` (:func:`synthesis_cuda.synthesis_basis`). A W row that
    sums to 0 gives what the JAX package gives: no guard."""
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    wn = (w / w.sum(dim=-1, keepdim=True)).T.contiguous()
    return TfSynthesisBasis(wn, *synthesis_basis(window, gain, matmul_dtype, device=w.device))


def wiener_spectra_plain(spec_re, spec_im, h_mask, wn, matmul_dtype="bfloat16"):
    """X = ``(h_mask·Wn) ⊙ planes``, ``(Re X, Im X)`` each (B, C, T, F)
    fp32: the spectra that the iDFT of :func:`tf_synthesis_plain` reads
    (bf16 operands in the bf16 mode)."""
    r = round_bf16 if bf16_operands(matmul_dtype) else (lambda x: x)
    f = wn.shape[-1]
    tf = r(h_mask.to(torch.float32)) @ r(wn)  # (B, T, F)
    return (tf[:, None] * spec_re[..., :f].to(torch.float32),
            tf[:, None] * spec_im[..., :f].to(torch.float32))


def tf_synthesis_plain(spec_re, spec_im, h_mask, basis, *, hop_size, matmul_dtype="bfloat16"):
    """Plain torch version of :func:`tf_synthesis_cuda`."""
    xr, xi = wiener_spectra_plain(spec_re, spec_im, h_mask, basis[0], matmul_dtype)
    return istft_plain(xr, xi, basis[1:], hop_size, matmul_dtype)


def tf_synthesis_cuda(spec_re, spec_im, h_mask, basis, *, hop_size, matmul_dtype="bfloat16"):
    """Fused Wiener-masked ISTFT (conjugate + center trim) → (B, C,
    (T-1)·hop) fp32.

    ``spec_re``/``spec_im``: (B, C, T, Fp) fp32 or bf16 planes, ``Fp >= F``;
    ``h_mask``: (B, T, K); ``basis``: from :func:`tf_synthesis_basis` in the
    same ``matmul_dtype``. ``matmul_dtype="bfloat16"`` rounds where JAX's
    ``make_mm`` does: the Wiener GEMM's operands, the masked planes and the
    iDFT basis, and the frames entering the overlap-add, and runs the iDFT
    on the tensor cores. Launches the CUDA kernels for CUDA planes; CPU
    planes take :func:`tf_synthesis_plain`. ``tf_synthesis_cuda.launches``
    counts its calls, not the device kernels each one launches."""
    rnd = bf16_operands(matmul_dtype)
    if spec_re.device.type == "cpu":
        return tf_synthesis_plain(spec_re, spec_im, h_mask, basis, hop_size=hop_size,
                                  matmul_dtype=matmul_dtype)
    wn = basis[0]
    dev = _build.require_cuda("tf_synthesis_cuda", spec_re, spec_im, h_mask, *basis[:3])
    b, c, t, fp = spec_re.shape
    f, win = basis[1].shape
    k = wn.shape[0]
    if win % hop_size:
        raise ValueError("tf_synthesis_cuda: window length must be a multiple of hop_size")
    if spec_im.shape != spec_re.shape or spec_im.dtype != spec_re.dtype:
        raise ValueError("tf_synthesis_cuda: spec planes disagree")
    if spec_re.dtype not in (torch.float32, torch.bfloat16) or fp < f:
        raise ValueError("tf_synthesis_cuda: planes must be fp32/bf16 with >= F bins")
    if h_mask.shape != (b, t, k) or wn.shape != (k, f):
        raise ValueError("tf_synthesis_cuda: h_mask or Wn shape disagrees")
    fft, rows = check_idft_basis("tf_synthesis_cuda", basis[1:], rnd, f, win, dev)
    sre, sim = spec_re.contiguous(), spec_im.contiguous()
    hm = h_mask.to(torch.float32).contiguous()
    wn = wn.to(torch.float32).contiguous()
    ldj = row_pad(2 * f)
    # X scratch: bf16 spectrum rows for the tensor cores, or two fp32 planes
    x = (torch.empty((b * c * t, ldj), device=dev, dtype=torch.bfloat16) if rnd
         else torch.empty((2, b * c, t, f), device=dev, dtype=torch.float32))
    frames = torch.empty((b * c, t, win), device=dev, dtype=x.dtype)
    out = torch.empty((b, c, (t - 1) * hop_size), device=dev, dtype=torch.float32)
    _build.launch(
        "gccnmf_tf_synthesis", dev,
        sre.data_ptr(), sim.data_ptr(), int(sre.dtype == torch.bfloat16), fp,
        hm.data_ptr(), wn.data_ptr(), *idft_args(fft, rows), ldj,
        x.data_ptr(), frames.data_ptr(), out.data_ptr(),
        b, c, t, f, k, win, hop_size, int(rnd),
    )
    tf_synthesis_cuda.launches += 1
    return out


tf_synthesis_cuda.launches = 0


def enhance_synthesis_cuda(spec_re, spec_im, coh_re, coh_im, mask_basis, tf_basis,
                           target_index, target_epsilon, target_beta, noise_floor, *,
                           hop_size, matmul_dtype="bfloat16"):
    """The whole fused enhancement tail → (B, C, (T-1)·hop):
    :func:`soft_mask_cuda` then :func:`tf_synthesis_cuda`, with only the
    (B, T, K) coefficient mask between them."""
    h_mask = soft_mask_cuda(coh_re, coh_im, mask_basis, target_index, target_epsilon,
                            target_beta, noise_floor, matmul_dtype=matmul_dtype)
    return tf_synthesis_cuda(spec_re, spec_im, h_mask, tf_basis, hop_size=hop_size,
                             matmul_dtype=matmul_dtype)
