"""The pipeline, the stream helpers and the mesh of the port, under the
JAX package's names (audio_metrics_tpu/parallel/__init__.py).  Its
``batch_sharding``, ``replicated_sharding`` and ``DATA_AXIS`` are JAX
``NamedSharding`` objects and have no counterpart: ``mesh.Mesh`` places
the work."""

from .mesh import make_mesh
from .pipeline import ItemCategory, embedding_pipeline
from .shuffle import shuffle_stream
from .stream import cpu_parallel, device_map_stream

__all__ = [
    "embedding_pipeline",
    "ItemCategory",
    "shuffle_stream",
    "make_mesh",
    "cpu_parallel",
    "device_map_stream",
]
