"""Host helpers the checkers share: a pooled parallel map."""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Sequence


def bounded_pmap(f: Callable, xs: Sequence, limit: int | None = None) -> list:
    """Pooled parallel map (dom-top's bounded-pmap; independent.checker
    maps keys through it, independent.clj:285-307).  Results keep the
    order of ``xs``; the first exception raised by ``f`` propagates."""
    if not xs:
        return []
    limit = limit or max(2, (len(xs) + 1) // 2)
    with concurrent.futures.ThreadPoolExecutor(max_workers=limit) as ex:
        return list(ex.map(f, xs))
