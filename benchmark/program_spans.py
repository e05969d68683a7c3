"""The program's own spans (``dhaug_torch.utils.profiling``) as the
per-layer readers see them: only those of the traced chunks that the
window counts.

``harness.traced_chunks`` profiles ``n`` chunks and counts them, then runs
one more chunk under host-op profiling, whose host times are inflated,
only to name the idle gaps; a test process may also still hold the
records of earlier runs.  So a reader takes the last ``(n + 1) x
per_chunk`` root spans of its name and drops the final chunk's
``per_chunk``.  A checkout whose program records no spans reads None."""
from __future__ import annotations


def counted(ctx, root: str, per_chunk: int):
    """The records of every span under the ``root`` spans of the window's
    counted chunks (``per_chunk`` such roots a chunk), or None."""
    try:
        from dhaug_torch.utils.profiling import span_records
    except ImportError:
        return None
    records = span_records()
    roots = [r.root for r in records if r.parent_id < 0 and r.name == root]
    n = ctx.window.chunks * per_chunk
    if n == 0 or len(roots) < n + per_chunk:
        return None
    keep = set(roots[-(n + per_chunk):-per_chunk])
    return [r for r in records if r.root in keep]


def is_critic(name: str) -> bool:
    """A critic update's span, ``gan.critic.<role>``, not one of its parts."""
    return name.startswith("gan.critic.") and name.count(".") == 2


def select(records, name) -> list:
    """The records named ``name``, or whose name passes ``name`` when it is
    a function."""
    test = name if callable(name) else name.__eq__
    return [r for r in records if test(r.name)]


def mean_ms(records, name):
    """Mean milliseconds of the spans :func:`select` picks, or None."""
    if records is None:
        return None
    picked = select(records, name)
    return sum(r.ms for r in picked) / len(picked) if picked else None


def syncs_per(records, name):
    """The synchronizations of all ``records`` over the spans named
    ``name``, or None."""
    if records is None:
        return None
    units = len(select(records, name))
    return sum(r.syncs for r in records) / units if units else None
