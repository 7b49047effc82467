"""The LM head's cross entropy over a chunk of rows: the hand-written Hopper
kernel and its plain version.

**Replaces no Pallas kernel.**  The reference's cross entropy
(``src/repro/models/common.py:203``, ``chunked_ce_loss``) is ``jnp`` that
XLA fuses.  The port's eager chain for it formed each chunk's (B, c, V)
logits in f32 (``.float()`` of the bf16 head product), ran ``logsumexp``
and a ``gather`` on them, and formed all of it again under ``checkpoint``
in the backward, where softmax·g and a scattered one-hot were added and
cast back to bf16: about ten passes over f32 rows a chunk.

**What bounds it on an H100: bytes.**  At qwen1.5-0.5b's training chunk
(4096 rows of 151,936 bf16 logits, 1.245 GB) the logits read once and the
gradient written once are 2.49 GB, 0.74 ms at 3.35 TB/s.  The eager chain
moved about 66 GB a chunk.

**What the design does about it.**  One launch a chunk: a block a row,
16-byte loads, an online max and sum of exponentials in f32 (pass 1), then
the gradient stored over the logits in their own dtype (pass 2, which walks
the row backwards so that it finds in L2 what pass 1 read last).  No f32
copy of the logits and no second head product exist: the caller
(``models.common.HeadLossFunction``) forms the gradient in the forward.
No atomics: the same inputs give the same outputs on every run.

**Numbers.**  Softcap, lse, softmax and z-loss in f32, the gradient
rounded once to the logits' dtype, as the chain's ``.float()`` backward
rounded it; only the order of each row's f32 sum differs.

``cross_entropy`` dispatches on the device of its logits: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
There is no fallback; every check comes before the library is built or
bound.  ``cross_entropy.launches`` counts launches.  A fake tensor (the
dry run's) takes the card's branch up to the launch, as
``kernels/cost.py`` says.
"""
from __future__ import annotations

import ctypes

import torch

from . import cost

DTYPES = (torch.float32, torch.bfloat16)


def cross_entropy_plain(logits, targets, n_tok, *, softcap: float = 0.0,
                        z_coef: float = 0.0, ignore_id: int = -1,
                        grad: bool = False):
    """(lse, nll, zsq), each (R,) f32, of logits (R, V): the row's lse of
    the (softcapped) f32 logits; lse − the target's logit (a target below
    0 reads column 0, as the chain's clamp did) and lse², both 0 where the
    target is ``ignore_id``.  With ``grad`` the logits are
    overwritten by their gradient, (softmax·(1 + 2·z_coef·lse) −
    onehot) / n_tok (times 1 − tanh² under a softcap), 0 on an ignored
    row, rounded once to their dtype.  ``n_tok`` is a one-element tensor."""
    x = logits.float()
    if softcap > 0.0:
        th = torch.tanh(x / softcap)
        x = th * softcap
    lse = torch.logsumexp(x, dim=-1)
    valid = targets != ignore_id
    at = targets.long().clamp_min(0)[:, None]
    nll = torch.where(valid, lse - x.gather(-1, at)[:, 0], 0.0)
    zsq = torch.where(valid, lse * lse, 0.0)
    if grad:
        inv_n = n_tok.reshape(()).float().reciprocal()
        a = torch.where(valid, (1.0 + 2.0 * z_coef * lse) * inv_n, 0.0)
        g = torch.exp(x - lse[:, None]) * a[:, None]
        g.scatter_add_(-1, at, -valid[:, None].float() * inv_n)
        if softcap > 0.0:
            g = g * (1.0 - th * th)
        logits.copy_(g)
    return lse, nll, zsq


def cross_entropy(logits, targets, n_tok, *, softcap: float = 0.0,
                  z_coef: float = 0.0, ignore_id: int = -1,
                  grad: bool = False):
    """``cross_entropy_plain`` on the CPU, the kernel on the card; no
    fallback."""
    if cost.route(logits, "cross_entropy") == "plain":
        return cross_entropy_plain(logits, targets, n_tok, softcap=softcap,
                                   z_coef=z_coef, ignore_id=ignore_id,
                                   grad=grad)
    return _cross_entropy_cuda(logits, targets, n_tok, softcap=softcap,
                               z_coef=z_coef, ignore_id=ignore_id, grad=grad)


cross_entropy.launches = 0

_fn = None   # the C entry, bound once by _kernel()


def _kernel():
    """The kernel's C entry with its signature set, built and loaded at the
    first launch.  Two threads racing here bind the same function."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("cross_entropy").repro_cross_entropy
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_float] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
        _fn = fn
    return _fn


def _cross_entropy_cuda(logits, targets, n_tok, *, softcap, z_coef,
                        ignore_id, grad):
    """Validate, then launch ``ce_kernel``: a block a row.  Every check
    comes before the kernel is built or bound."""
    if logits.ndim != 2 or logits.dtype not in DTYPES:
        raise ValueError(f"cross_entropy: logits must be (R, V) float32 or "
                         f"bfloat16, got {tuple(logits.shape)} "
                         f"{logits.dtype}")
    R, V = logits.shape
    if R < 1 or V < 1 or R >= 2 ** 31 or V >= 2 ** 31:
        raise ValueError(f"cross_entropy: needs 1 <= R, V < 2**31; got "
                         f"R={R}, V={V}")
    if not logits.is_contiguous():
        raise ValueError("cross_entropy: the logits must be contiguous: "
                         "the gradient is written over them")
    if targets.shape != (R,) or targets.dtype != torch.int64:
        raise ValueError(f"cross_entropy: targets must be ({R},) int64, got "
                         f"{tuple(targets.shape)} {targets.dtype}")
    if n_tok.numel() != 1 or n_tok.dtype != torch.int64:
        raise ValueError("cross_entropy: n_tok must be one int64")
    if softcap < 0.0:
        raise ValueError(f"cross_entropy: softcap must be >= 0, got "
                         f"{softcap}")
    if not (logits.device == targets.device == n_tok.device):
        raise ValueError("cross_entropy: every input must be on one device")
    targets = targets.contiguous()
    lse, nll, zsq = (torch.empty(R, dtype=torch.float32,
                                 device=logits.device) for _ in range(3))
    if cost.is_fake(logits):
        cost.add("cross_entropy", *cost.cross_entropy_work(
            R, V, logits.element_size(), grad, softcap > 0.0))
        return lse, nll, zsq
    fn = _kernel()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = fn(logits.data_ptr(), targets.data_ptr(), n_tok.data_ptr(),
                 lse.data_ptr(), nll.data_ptr(), zsq.data_ptr(), R, V,
                 float(softcap), float(z_coef), int(ignore_id), int(grad),
                 int(logits.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"cross_entropy kernel launch failed: CUDA error "
                           f"{err}")
    cross_entropy.launches += 1
    return lse, nll, zsq
