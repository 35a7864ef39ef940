"""What every captured program shares: the capture that counts what it
launches.

A replay runs no Python, so the kernel wrappers' launch counters
(``.launches``, ``.wide_launches``, ``.xwide_launches``) do not move while
a graph runs. A capture records what each wrapper counted while the graph
was captured (the capture itself runs nothing on the device), puts the
counters back as they were, and each replay then advances them by that
record: the counts are those of the eager run.

``train/graphed.py`` (the training step bodies) and ``detect/graphed.py``
(the one-call detector and its grid) both capture through here.
"""

from __future__ import annotations

COUNTERS = ("launches", "wide_launches", "xwide_launches")


def counted_wrappers():
    """Every kernel wrapper with launch counters."""
    from hypad_tpu_torch.manifold.kernels import mobius_linear_kernel
    from hypad_tpu_torch.ops.kde_kernel import (
        kde_argmax_kernel,
        kde_argmax_v2_kernel,
    )
    from hypad_tpu_torch.train.critic_kernel import (
        critic_step_fused_full,
        critics_fused_grads,
    )

    return (mobius_linear_kernel, kde_argmax_kernel, kde_argmax_v2_kernel,
            critics_fused_grads, critic_step_fused_full)


def read_counters():
    """{(wrapper, counter name): count} of every wrapper."""
    return {(fn, c): getattr(fn, c) for fn in counted_wrappers()
            for c in COUNTERS}


def counted_capture(capture):
    """Run ``capture()`` (a graph capture, which launches nothing) and
    return (its result, {(wrapper, counter name): n} of what the wrappers
    counted during it). The wrappers' counters are left as they were, also
    when the capture raises."""
    before = read_counters()
    try:
        out = capture()
    finally:
        after = read_counters()
        for (fn, c), n in before.items():
            setattr(fn, c, n)
    return out, {key: after[key] - n for key, n in before.items()
                 if after[key] != n}


def advance_counters(launches, replays):
    """Advance the wrappers' counters by ``replays`` times the record
    ``launches`` of :func:`counted_capture`."""
    for (fn, c), n in launches.items():
        setattr(fn, c, getattr(fn, c) + n * replays)
