"""Corpus sharding over the devices of one process or of a pod of
processes, and the data-parallel training mesh (counterpart of
``vsc2022_tpu/parallel``). The searcher over a
mesh is in ``vsc2022_torch.parallel.sharded_search``, the collectives in
``vsc2022_torch.parallel.collectives``, each imported where it is used."""

from vsc2022_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    corpus_mesh,
    first_axis_sharding,
    first_axis_size,
    initialize_distributed,
    local_device_count,
    pod_mesh,
    process_count,
    process_index,
    rank_device,
    shutdown_distributed,
    train_mesh,
)
