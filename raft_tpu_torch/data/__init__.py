"""Host-side data of the port: file formats, datasets, augmentation, the
sharded loader and the device pipeline."""

from raft_tpu_torch.data.frame_utils import (  # noqa: F401
    read_disp_kitti,
    read_flo,
    read_flow_kitti,
    read_gen,
    read_image,
    read_pfm,
    write_flo,
    write_flow_kitti,
    write_pfm,
)
from raft_tpu_torch.data.png16 import read_png, write_png  # noqa: F401
from raft_tpu_torch.data.datasets import (  # noqa: F401
    ConcatFlowDataset,
    FlowDataset,
    FlyingChairs,
    FlyingThings3D,
    HD1K,
    KITTI,
    MpiSintel,
    SampleReadError,
    ShardedLoader,
    fetch_dataset,
)
from raft_tpu_torch.data.augment import (  # noqa: F401
    ColorJitter,
    FlowAugmentor,
    SparseFlowAugmentor,
)
from raft_tpu_torch.data.prefetch import (  # noqa: F401
    DevicePipeline,
    PipelineInterrupted,
)
