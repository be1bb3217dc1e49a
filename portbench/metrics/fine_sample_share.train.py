"""The fine pass's samples over all the samples the program rendered, %,
from its sample counter (`utils/tracing.py::samples`: R x S a coarse pass,
R x (S + n_fine) a fine one), read over the process's life: every step of a
train run renders the same shapes (the set-up's steps, the window, the
traced stretch), so this is each step's share, 128 / 192 at 64 + 64. None
where the program has no such counter or rendered nothing."""

from portbench import readers


def read(r: readers.Readings):
    from dual_space_nerf_tpu_torch.utils import tracing

    samples = getattr(tracing, "samples", None)
    if samples is None:
        return None
    got = samples()
    total = sum(got.values())
    return 100.0 * got.get("fine", 0) / total if total else None
