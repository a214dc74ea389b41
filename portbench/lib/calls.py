"""The call shapes of every hand-written kernel a traced window runs.

``recorded()`` wraps each kernel entry of ``repro_torch.kernels.ops`` for
the length of a ``with`` block and appends one record a call to the list
of its counter, the shapes the kernel's roofline reader counts with
(``counts/kernels.py``):

  ================  ===========  ==============================================
  entry             counter      record
  ================  ===========  ==============================================
  power_spectrum    spectrum     x's shape (B, N)
  autocorr_score    autocorr     (J, N, the lags as a list)
  dirty_blocks_many scans        ([(elements, bytes each) of each float
                                 leaf], block)
  ssm_scan          ssm_scan     (B, H, S, Dk, Dv, ((distinct elements, bytes
                                 each) of q, k, v, log_decay and any bonus
                                 and initial state), bonus given, initial
                                 state given)
  flash_attention   attention    (B, H, Hkv, S, D, bytes each, window)
  ================  ===========  ==============================================

The program calls each entry through the module (``ops.<entry>``), so a
wrapper set on the module sees every call. A later kernel is a new row
here, and its reader a new file.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Tuple


def distinct(t) -> int:
    """Elements of ``t`` that differ in memory: a stride-0 (broadcast)
    dimension counts once."""
    return math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0)


def _spectrum(x, *a, **kw):
    return tuple(x.shape)


def _autocorr(x, lags, *a, **kw):
    return (*x.shape, lags.tolist())


def _scans(news, olds, *a, **kw):
    return ([(n.numel(), n.element_size()) for n in news
             if n.is_floating_point()], kw["block"])


def _ssm_scan(q, k, v, log_decay, *, bonus=None, initial_state=None):
    B, H, S, Dk = q.shape
    given = [t for t in (q, k, v, log_decay, bonus, initial_state)
             if t is not None]
    return (B, H, S, Dk, v.shape[-1],
            tuple((distinct(t), t.element_size()) for t in given),
            bonus is not None, initial_state is not None)


def _attention(q, k, v, **kw):
    return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
            q.element_size(), kw.get("window", 0))


#: entry of ``ops`` -> (counter, its record of a call's arguments)
ENTRIES: Dict[str, Tuple[str, Callable]] = {
    "power_spectrum": ("spectrum", _spectrum),
    "autocorr_score": ("autocorr", _autocorr),
    "dirty_blocks_many": ("scans", _scans),
    "ssm_scan": ("ssm_scan", _ssm_scan),
    "flash_attention": ("attention", _attention),
}


def _wrap(fn: Callable, out: List, shape: Callable) -> Callable:
    def recording(*a, **kw):
        out.append(shape(*a, **kw))
        return fn(*a, **kw)
    return recording


@contextlib.contextmanager
def recorded() -> Iterator[Dict[str, List]]:
    """Inside the block every kernel entry of ``ops`` is recorded; yields
    counter -> list of records (every counter present, empty where its
    kernel did not run). The entries are restored on the way out."""
    from repro_torch.kernels import ops
    calls: Dict[str, List] = {c: [] for c, _ in ENTRIES.values()}
    saved = {name: getattr(ops, name) for name in ENTRIES}
    try:
        for name, (counter, shape) in ENTRIES.items():
            setattr(ops, name, _wrap(saved[name], calls[counter], shape))
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
