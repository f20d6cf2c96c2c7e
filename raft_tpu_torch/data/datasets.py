"""Optical-flow datasets and the sharded training loader (the port's copy
of ``raft_tpu/data/datasets.py``).

The five dataset classes with the reference directory conventions
(``MpiSintel``, ``FlyingChairs``, ``FlyingThings3D``, ``KITTI``,
``HD1K``), the replicate-and-concatenate mixing (``100 * clean + final``),
grayscale tiling and alpha dropping, the dense validity rule
``|flow| < 1000``, training augmentation (``data/augment.py``), the stage
mixtures (:func:`fetch_dataset`) and :class:`ShardedLoader`.  Samples are
NumPy NHWC arrays; batches are dicts of stacked arrays.

``ShardedLoader`` shuffles the whole dataset per epoch from
``SeedSequence([seed, epoch])`` and gives each rank a disjoint stride of
the permutation; each sample is augmented with a generator from
``SeedSequence([seed, epoch, index])``, so the stream does not depend on
how the worker threads are scheduled.  Decoding and augmentation run in a
thread pool (the native C ops and PIL release the GIL).
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch import chaos
from raft_tpu_torch.data import frame_utils
from raft_tpu_torch.data.augment import FlowAugmentor, SparseFlowAugmentor


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
        self.sparse = sparse
        self.is_test = False
        self.augmentor = None
        if aug_params is not None:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params)
        self.name = type(self).__name__
        self.split: Optional[str] = None
        self.flow_list: List[str] = []
        self.image_list: List[Tuple[str, str]] = []
        self.extra_info: List[tuple] = []

    def _clone_shell(self) -> "FlowDataset":
        out = FlowDataset.__new__(FlowDataset)
        out.sparse = self.sparse
        out.is_test = self.is_test
        out.augmentor = self.augmentor
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

    def load(self, index: int,
             rng: Optional[np.random.Generator] = None
             ) -> Dict[str, np.ndarray]:
        """One sample: float32 ``image1`` / ``image2`` (H, W, 3) in
        [0, 255], ``flow`` (H, W, 2) and ``valid`` (H, W), augmented with
        ``rng`` (a fresh unseeded generator when None) when the dataset has
        an augmentor; a test split gives the images and ``extra_info``
        only."""
        ds, index = self._sample_parts(index)
        index = index % len(ds.image_list)
        if chaos.should_inject("corrupt_image", point="data.sample_read"):
            raise SampleReadError(ds.image_list[index][0], ds, index,
                                  "chaos-injected corrupt sample")
        img1 = _read_sample(ds, index, ds.image_list[index][0],
                            lambda p: _to_rgb(frame_utils.read_gen(p)))
        img2 = _read_sample(ds, index, ds.image_list[index][1],
                            lambda p: _to_rgb(frame_utils.read_gen(p)))
        if ds.is_test:
            return {"image1": img1.astype(np.float32),
                    "image2": img2.astype(np.float32),
                    "extra_info": ds.extra_info[index]}

        valid = None
        if ds.sparse:
            flow, valid = _read_sample(ds, index, ds.flow_list[index],
                                       frame_utils.read_flow_kitti)
        else:
            flow = _read_sample(
                ds, index, ds.flow_list[index],
                lambda p: np.asarray(frame_utils.read_gen(p), np.float32))

        if ds.augmentor is not None:
            if rng is None:
                rng = np.random.default_rng()
            if ds.sparse:
                img1, img2, flow, valid = ds.augmentor(
                    rng, img1, img2, flow, valid)
            else:
                img1, img2, flow = ds.augmentor(rng, img1, img2, flow)

        if valid is None:
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


# ---------------------------------------------------------------------------
# Stage mixtures
# ---------------------------------------------------------------------------

def fetch_dataset(stage: str, image_size: Tuple[int, int],
                  root: str = "datasets", train_ds: str = "C+T+K+S+H",
                  split_file: str = "chairs_split.txt") -> FlowDataset:
    """The training mixture of ``stage`` with the reference's augmentation
    parameters and replication weights."""
    crop = {"crop_size": tuple(image_size)}
    if stage == "chairs":
        aug = dict(crop, min_scale=-0.1, max_scale=1.0, do_flip=True)
        return FlyingChairs(aug, split="training",
                            root=osp.join(root, "FlyingChairs_release/data"),
                            split_file=split_file)
    if stage == "things":
        aug = dict(crop, min_scale=-0.4, max_scale=0.8, do_flip=True)
        things_root = osp.join(root, "FlyingThings3D")
        clean = FlyingThings3D(aug, root=things_root,
                               dstype="frames_cleanpass")
        final = FlyingThings3D(aug, root=things_root,
                               dstype="frames_finalpass")
        return clean + final
    if stage == "sintel":
        aug = dict(crop, min_scale=-0.2, max_scale=0.6, do_flip=True)
        things = FlyingThings3D(aug, root=osp.join(root, "FlyingThings3D"),
                                dstype="frames_cleanpass")
        clean = MpiSintel(aug, split="training",
                          root=osp.join(root, "Sintel"), dstype="clean")
        final = MpiSintel(aug, split="training",
                          root=osp.join(root, "Sintel"), dstype="final")
        if train_ds == "C+T+K+S+H":
            kitti = KITTI(dict(crop, min_scale=-0.3, max_scale=0.5,
                               do_flip=True), root=osp.join(root, "KITTI"))
            hd1k = HD1K(dict(crop, min_scale=-0.5, max_scale=0.2,
                             do_flip=True), root=osp.join(root, "HD1k"))
            return 100 * clean + 100 * final + 200 * kitti + 5 * hd1k + things
        if train_ds == "C+T+K/S":
            return 100 * clean + 100 * final + things
        raise ValueError(f"unknown train_ds mixture: {train_ds!r}")
    if stage == "kitti":
        aug = dict(crop, min_scale=-0.2, max_scale=0.4, do_flip=False)
        return KITTI(aug, split="training", root=osp.join(root, "KITTI"))
    raise ValueError(f"unknown stage: {stage!r}")


# ---------------------------------------------------------------------------
# Sharded loader
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedLoader:
    """A globally shuffled, per-rank sharded batch iterator with a thread
    pool.  Batches are dicts of stacked NHWC float32 arrays of
    ``batch_size`` samples.

    ``prefetch_batches``: how many batches of decode futures the pool keeps
    in flight ahead of the consumer; 0 = ``max(2 * batch_size,
    2 * num_workers)`` samples.  A sample whose read fails
    (``ValueError`` / ``OSError``) is retried ``sample_retries`` times, then
    quarantined (``quarantined_total`` counts it, one line is printed, a
    ``sample_quarantine`` event goes to ``sink`` and the counter
    ``raft_data_quarantined_total`` of ``registry`` grows by one; None =
    the process-wide defaults, which the train loop points at its own) and
    replaced by an index drawn from ``SeedSequence([seed, epoch, index,
    _RESAMPLE_SALT, resample])``, up to ``sample_resamples`` times; any
    other error propagates.
    """

    dataset: FlowDataset
    batch_size: int            # per-rank batch size
    seed: int = 1234
    num_hosts: int = 1
    host_id: int = 0
    num_workers: int = 4
    drop_last: bool = True
    prefetch_batches: int = 0
    sample_retries: int = 1
    sample_resamples: int = 8
    sink: Optional[object] = None
    registry: Optional[object] = None

    #: Salt that separates replacement-index draws from the per-sample
    #: augmentation streams (the JAX package's constant).
    _RESAMPLE_SALT = 0x51A7

    def __post_init__(self):
        if not 0 <= self.host_id < self.num_hosts:
            raise ValueError(f"host_id {self.host_id} outside "
                             f"[0, {self.num_hosts})")
        if len(self.dataset) == 0:
            raise ValueError("empty dataset")
        for name in ("prefetch_batches", "sample_retries",
                     "sample_resamples"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got "
                                 f"{getattr(self, name)}")
        self.quarantined_total = 0
        self._quarantine_lock = threading.Lock()

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This rank's sample indices of ``epoch``: a disjoint stride of a
        permutation that every rank draws alike."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        perm = rng.permutation(len(self.dataset))
        return perm[self.host_id::self.num_hosts]

    def _load_one(self, epoch: int, index: int) -> Dict[str, np.ndarray]:
        """One sample, retrying, quarantining and replacing a failed read
        (see the class docstring)."""
        if chaos.should_inject("worker_err", point="data.loader_worker"):
            raise chaos.InjectedWorkerCrash(
                "chaos-injected loader-worker crash (not a decode "
                "error: must fail the run, not quarantine)")
        index = int(index)
        idx, last_err = index, None
        for resample in range(self.sample_resamples + 1):
            for _attempt in range(self.sample_retries + 1):
                # a fresh generator per attempt: a replacement sees exactly
                # the draws it would get as a first-class sample
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, epoch, idx]))
                try:
                    return self.dataset.load(idx, rng)
                except (ValueError, OSError) as e:
                    last_err = e
            self._quarantine(epoch, index, idx, resample, last_err)
            r = np.random.default_rng(np.random.SeedSequence(
                [self.seed, epoch, index, self._RESAMPLE_SALT, resample]))
            idx = int(r.integers(len(self.dataset)))
        raise RuntimeError(
            f"sample {index} and {self.sample_resamples} replacement "
            f"draw(s) all failed to load; giving up (last error: "
            f"{type(last_err).__name__}: {last_err})") from last_err

    def _quarantine(self, epoch: int, index: int, idx: int,
                    resample: int, err: Exception) -> None:
        from raft_tpu_torch.obs.events import default_sink
        from raft_tpu_torch.obs.registry import default_registry

        with self._quarantine_lock:
            self.quarantined_total += 1
        print(f"sample quarantined: epoch {epoch} index {idx} (for "
              f"{index}, resample {resample}) after "
              f"{self.sample_retries + 1} attempt(s): "
              f"{type(err).__name__}: {err}", flush=True)
        reg = self.registry if self.registry is not None \
            else default_registry()
        reg.counter(
            "raft_data_quarantined_total",
            "samples skipped after repeated read failures "
            "(replaced by a deterministic resample)").inc()
        sink = self.sink if self.sink is not None else default_sink()
        sink.emit("sample_quarantine",
                  dataset=getattr(err, "dataset_name", None)
                  or getattr(self.dataset, "name",
                             type(self.dataset).__name__),
                  split=getattr(err, "split", None),
                  path=getattr(err, "path", None),
                  epoch=int(epoch), index=int(idx),
                  original_index=int(index), resample=int(resample),
                  retries=int(self.sample_retries),
                  error=f"{type(err).__name__}: {err}")

    def steps_per_epoch(self) -> int:
        """Batches per epoch on this rank (the same every epoch)."""
        n = len(self.epoch_indices(0))
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def batches_from_step(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        """The stream as if ``step`` batches had been drawn already: a
        resumed run continues the shuffle instead of replaying epoch 0."""
        spe = self.steps_per_epoch()
        if spe == 0:
            raise ValueError(
                f"per-rank dataset share smaller than "
                f"batch_size={self.batch_size} with drop_last: no "
                "batches would ever be produced")
        start_epoch, skip = divmod(step, spe)
        return self.batches(start_epoch, skip_batches=skip)

    def batches(self, start_epoch: int = 0,
                skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The endless stream, epoch after epoch.  ``skip_batches`` drops
        the first batches of the first epoch without decoding them."""
        epoch = start_epoch
        window = (self.prefetch_batches * self.batch_size
                  if self.prefetch_batches > 0
                  else max(2 * self.batch_size, 2 * self.num_workers))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            while True:
                idx = self.epoch_indices(epoch)
                n = len(idx)
                usable = (n // self.batch_size) * self.batch_size \
                    if self.drop_last else n
                if usable == 0:
                    raise ValueError(
                        f"per-rank dataset share ({n} samples) smaller than "
                        f"batch_size={self.batch_size} with drop_last: no "
                        "batches would ever be produced")
                if epoch == start_epoch and skip_batches:
                    skipped = min(skip_batches * self.batch_size, usable)
                    idx = idx[skipped:]
                    usable -= skipped
                pending = deque()
                it = iter(idx[:usable])
                for i in it:
                    pending.append(pool.submit(self._load_one, epoch, i))
                    if len(pending) >= window:
                        break
                buf: List[Dict[str, np.ndarray]] = []
                while pending:
                    buf.append(pending.popleft().result())
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(
                            pool.submit(self._load_one, epoch, nxt))
                    if len(buf) == self.batch_size:
                        yield {k: np.stack([b[k] for b in buf])
                               for k in buf[0]}
                        buf = []
                if buf and not self.drop_last:
                    yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
                epoch += 1
