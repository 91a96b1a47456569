"""ray_tpu_torch.data: streaming datasets, the port of ray_tpu's ``data``.

Lazy logical plans over blocks (dicts of numpy columns) in a local object
store, a streaming executor with bounded in-flight backpressure, task- and
actor-pool map operators, map/reduce shuffles, and ML-ingest iterators
(``streaming_split`` into the trainer's gang, resumable across a resize).
Tasks and actors run on worker processes of this host
(``ray_tpu_torch._private.local_tasks``). The package exports the
reference's ``__all__`` and needs numpy and the standard library alone at
import; pyarrow, pandas and PIL only for the calls that read or give their
types.
"""

from ray_tpu_torch.data.block import BlockAccessor, BlockMetadata, DataContext
from ray_tpu_torch.data.dataset import Dataset, GroupedData, from_block_refs
from ray_tpu_torch.data.datasource import Datasink, Datasource, ReadTask
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    from_torch,
    range,
    range_tensor,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
)
from ray_tpu_torch.data._internal.shuffle import Count, Max, Mean, Min, Std, Sum

__all__ = [
    "Dataset",
    "GroupedData",
    "DataIterator",
    "DataContext",
    "BlockAccessor",
    "BlockMetadata",
    "from_block_refs",
    "from_items",
    "from_numpy",
    "from_arrow",
    "from_pandas",
    "from_torch",
    "from_huggingface",
    "range",
    "range_tensor",
    "read_parquet",
    "read_csv",
    "read_json",
    "read_numpy",
    "read_images",
    "read_text",
    "read_tfrecords",
    "read_datasource",
    "Datasource",
    "Datasink",
    "ReadTask",
    "Count",
    "Sum",
    "Min",
    "Max",
    "Mean",
    "Std",
]
