"""Optical-flow datasets (the port's copy of ``raft_tpu/data/datasets.py``).

The five dataset classes with the reference directory conventions
(``MpiSintel``, ``FlyingChairs``, ``FlyingThings3D``, ``KITTI``,
``HD1K``), the replicate-and-concatenate mixing (``100 * clean + final``),
grayscale tiling and alpha dropping, and the dense validity rule
``|flow| < 1000``.  Samples are NumPy NHWC arrays.

Training augmentation is not ported yet: a dataset built with
``aug_params`` raises ``NotImplementedError`` (ROADMAP A4.1, the
augmentors, with ``fetch_dataset``).
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.data import frame_utils


class SampleReadError(ValueError):
    """A read or decode failure of one sample, naming the dataset, split,
    sample index and file path beside the reader's own message."""

    def __init__(self, path: str, dataset=None, index=None,
                 detail: str = ""):
        self.path = path
        self.dataset_name = getattr(dataset, "name", None) \
            or type(dataset).__name__
        self.split = getattr(dataset, "split", None)
        self.index = index
        super().__init__(
            f"{path}: {detail} [dataset={self.dataset_name} "
            f"split={self.split or '-'} sample={index}]")


def _read_sample(ds, index: int, path: str, reader):
    """``reader(path)``, with the sample's provenance attached to a
    ``ValueError`` / ``OSError`` it raises."""
    try:
        return reader(path)
    except SampleReadError:
        raise
    except (ValueError, OSError) as e:
        raise SampleReadError(path, ds, index, str(e)) from e


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """Grayscale -> three tiled channels; alpha dropped."""
    img = np.asarray(img)
    if img.ndim == 2:
        return np.tile(img[..., None], (1, 1, 3)).astype(np.uint8)
    return img[..., :3].astype(np.uint8)


class FlowDataset:
    """Base dataset: lists of (img1, img2) paths and flow paths.

    ``dataset * n`` replicates the sample list and ``a + b`` concatenates;
    both return new datasets.
    """

    def __init__(self, aug_params: Optional[dict] = None,
                 sparse: bool = False):
        if aug_params is not None:
            raise NotImplementedError(
                "training augmentation (FlowAugmentor / SparseFlowAugmentor)"
                " is a later slice of the port (ROADMAP A4.1); pass "
                "aug_params=None")
        self.sparse = sparse
        self.is_test = False
        self.name = type(self).__name__
        self.split: Optional[str] = None
        self.flow_list: List[str] = []
        self.image_list: List[Tuple[str, str]] = []
        self.extra_info: List[tuple] = []

    def _clone_shell(self) -> "FlowDataset":
        out = FlowDataset.__new__(FlowDataset)
        out.sparse = self.sparse
        out.is_test = self.is_test
        out.name = self.name
        out.split = self.split
        out.flow_list = list(self.flow_list)
        out.image_list = list(self.image_list)
        out.extra_info = list(self.extra_info)
        return out

    def __mul__(self, v: int) -> "FlowDataset":
        out = self._clone_shell()
        out.flow_list = v * out.flow_list
        out.image_list = v * out.image_list
        out.extra_info = v * out.extra_info
        return out

    __rmul__ = __mul__

    def __add__(self, other: "FlowDataset") -> "ConcatFlowDataset":
        return ConcatFlowDataset([self, other])

    def __len__(self) -> int:
        return len(self.image_list)

    def _sample_parts(self, index: int):
        """The member dataset and its local index that serve ``index``."""
        return self, index

    def load(self, index: int) -> Dict[str, np.ndarray]:
        """One sample: float32 ``image1`` / ``image2`` (H, W, 3) in
        [0, 255], ``flow`` (H, W, 2) and ``valid`` (H, W); a test split
        gives the images and ``extra_info`` only."""
        ds, index = self._sample_parts(index)
        index = index % len(ds.image_list)
        img1 = _read_sample(ds, index, ds.image_list[index][0],
                            lambda p: _to_rgb(frame_utils.read_gen(p)))
        img2 = _read_sample(ds, index, ds.image_list[index][1],
                            lambda p: _to_rgb(frame_utils.read_gen(p)))
        if ds.is_test:
            return {"image1": img1.astype(np.float32),
                    "image2": img2.astype(np.float32),
                    "extra_info": ds.extra_info[index]}

        if ds.sparse:
            flow, valid = _read_sample(ds, index, ds.flow_list[index],
                                       frame_utils.read_flow_kitti)
        else:
            flow = _read_sample(
                ds, index, ds.flow_list[index],
                lambda p: np.asarray(frame_utils.read_gen(p), np.float32))
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000))
        return {"image1": img1.astype(np.float32),
                "image2": img2.astype(np.float32),
                "flow": flow.astype(np.float32),
                "valid": np.asarray(valid, np.float32)}


class ConcatFlowDataset(FlowDataset):
    """Concatenation of datasets, dense or sparse."""

    def __init__(self, parts: Sequence[FlowDataset]):
        flat: List[FlowDataset] = []
        for p in parts:
            flat.extend(p.parts if isinstance(p, ConcatFlowDataset) else [p])
        self.parts = flat
        self.is_test = False
        self.name = "Concat(" + "+".join(p.name for p in flat) + ")"
        self.split = None  # per-sample context comes from the member
        self._offsets = np.cumsum([len(p) for p in flat])

    def __len__(self) -> int:
        return int(self._offsets[-1]) if len(self.parts) else 0

    def __mul__(self, v: int) -> "ConcatFlowDataset":
        return ConcatFlowDataset(list(self.parts) * v)

    __rmul__ = __mul__

    def _sample_parts(self, index: int):
        index = index % len(self)
        part = int(np.searchsorted(self._offsets, index, side="right"))
        local = index - (0 if part == 0 else int(self._offsets[part - 1]))
        return self.parts[part], local


class MpiSintel(FlowDataset):
    """Consecutive-frame pairs per scene."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/Sintel", dstype="clean"):
        super().__init__(aug_params)
        self.split = split
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        if split == "test":
            self.is_test = True
        for scene in sorted(os.listdir(image_root)):
            images = sorted(glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(images) - 1):
                self.image_list.append((images[i], images[i + 1]))
                self.extra_info.append((scene, i))
            if split != "test":
                self.flow_list += sorted(
                    glob(osp.join(flow_root, scene, "*.flo")))


class FlyingChairs(FlowDataset):
    """Train or validation split by the ids of ``chairs_split.txt``
    (1 = training, 2 = validation)."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/FlyingChairs_release/data",
                 split_file="chairs_split.txt"):
        super().__init__(aug_params)
        self.split = split
        images = sorted(glob(osp.join(root, "*.ppm")))
        flows = sorted(glob(osp.join(root, "*.flo")))
        if len(images) // 2 != len(flows):
            raise ValueError(f"{root}: {len(images)} images for "
                             f"{len(flows)} flows")
        split_ids = np.loadtxt(split_file, dtype=np.int32)
        if split in ("training", "train"):
            want = 1
        elif split in ("validation", "val"):
            want = 2
        else:
            raise ValueError(f"unknown FlyingChairs split: {split!r}")
        for i in range(len(flows)):
            if split_ids[i] == want:
                self.flow_list.append(flows[i])
                self.image_list.append((images[2 * i], images[2 * i + 1]))


class FlyingThings3D(FlowDataset):
    """Left camera, both temporal directions; ``into_past`` swaps the
    image order."""

    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass"):
        super().__init__(aug_params)
        self.split = dstype
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
                image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
                flow_dirs = sorted(
                    glob(osp.join(root, "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted(
                    osp.join(f, direction, cam) for f in flow_dirs)
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list.append((images[i], images[i + 1]))
                            self.flow_list.append(flows[i])
                        else:
                            self.image_list.append((images[i + 1], images[i]))
                            self.flow_list.append(flows[i + 1])


class KITTI(FlowDataset):
    """Sparse ``*_10.png`` / ``*_11.png`` pairs."""

    def __init__(self, aug_params=None, split="training",
                 root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
        self.split = split
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info.append((osp.basename(img1),))
            self.image_list.append((img1, img2))
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    """Sparse HD1K sequences, scanned by sequence index."""

    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True)
        seq_ix = 0
        while True:
            flows = sorted(glob(osp.join(
                root, "hd1k_flow_gt", "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob(osp.join(
                root, "hd1k_input", "image_2/%06d_*.png" % seq_ix)))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append((images[i], images[i + 1]))
            seq_ix += 1
