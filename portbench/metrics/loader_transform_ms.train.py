"""The loader's transform (``item_to_train_batch``, ``item_to_mesh``) per
item it yielded in the window, ms, from its counters
(`PrefetchLoader.stats`): time on its threads, which a step waits for
only when the queue runs dry."""

from portbench import readers


def read(r: readers.Readings):
    return readers.loader_transform_ms(r)
