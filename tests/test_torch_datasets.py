"""The port's datasets, stage mixtures and sharded loader against the JAX
package's (twins of tests/test_datasets.py and of the loader parts of
tests/test_chaos.py) on the same synthetic trees, written with the JAX
package's writers: equal sample lists and equal arrays from ``load(i)``
(augmented samples too, with the same generator), every stage's mixture
with JAX's members, weights and augmentation parameters, and the loader's
batch stream, resume and quarantine replacement bit-equal to JAX's."""

import dataclasses

import numpy as np
import pytest
from PIL import Image

from raft_tpu.data import datasets as jds
from raft_tpu.data import frame_utils
from raft_tpu_torch.data import datasets as tds

H, W = 96, 128


def _write_img(path, rng, size=(H, W), mode="RGB"):
    shape = size + ((3,) if mode == "RGB" else (4,) if mode == "RGBA" else ())
    Image.fromarray(rng.integers(0, 255, size=shape, dtype=np.uint8)).save(
        path)


def _same(tds_obj, jds_obj):
    """Equal lengths, sample lists and loaded samples for every index."""
    assert len(tds_obj) == len(jds_obj)
    for attr in ("image_list", "flow_list", "extra_info"):
        if hasattr(jds_obj, attr) and not isinstance(
                jds_obj, jds.ConcatFlowDataset):
            assert getattr(tds_obj, attr) == getattr(jds_obj, attr), attr
    for i in range(len(jds_obj)):
        got, want = tds_obj.load(i), jds_obj.load(i)
        assert got.keys() == want.keys()
        for k in want:
            if k == "extra_info":
                assert got[k] == want[k]
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture
def sintel_root(tmp_path):
    rng = np.random.default_rng(0)
    for split in ("training", "test"):
        for scene, n, mode in (("alley_1", 3, "RGB"), ("ambush_2", 2, "L")):
            img_dir = tmp_path / "Sintel" / split / "clean" / scene
            img_dir.mkdir(parents=True)
            for i in range(n):
                _write_img(img_dir / f"frame_{i:04d}.png", rng, mode=mode)
            if split == "training":
                flow_dir = tmp_path / "Sintel/training/flow" / scene
                flow_dir.mkdir(parents=True)
                for i in range(n - 1):
                    flow = rng.normal(size=(H, W, 2)).astype(np.float32)
                    flow[0, :4] = 2000.0     # invalid by |flow| >= 1000
                    frame_utils.write_flo(
                        str(flow_dir / f"frame_{i:04d}.flo"), flow)
    return str(tmp_path / "Sintel")


@pytest.fixture
def chairs_root(tmp_path):
    rng = np.random.default_rng(1)
    data = tmp_path / "FlyingChairs_release/data"
    data.mkdir(parents=True)
    for i in range(4):
        for k in (1, 2):
            Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
                            ).save(data / f"{i:05d}_img{k}.ppm", format="PPM")
        frame_utils.write_flo(str(data / f"{i:05d}_flow.flo"),
                              rng.normal(size=(H, W, 2)).astype(np.float32))
    split = tmp_path / "chairs_split.txt"
    split.write_text("1\n1\n2\n1\n")
    return str(data), str(split)


@pytest.fixture
def kitti_root(tmp_path):
    rng = np.random.default_rng(2)
    for split in ("training", "testing"):
        img_dir = tmp_path / "KITTI" / split / "image_2"
        img_dir.mkdir(parents=True)
        for i in range(2):
            _write_img(img_dir / f"{i:06d}_10.png", rng, mode="RGBA")
            _write_img(img_dir / f"{i:06d}_11.png", rng)
    flow_dir = tmp_path / "KITTI/training/flow_occ"
    flow_dir.mkdir(parents=True)
    for i in range(2):
        flow = rng.normal(scale=5, size=(H, W, 2))
        png = np.concatenate([64.0 * flow + 2 ** 15,
                              rng.random((H, W, 1)) > 1 / 3], -1)
        frame_utils.write_png(str(flow_dir / f"{i:06d}_10.png"),
                              png.astype(np.uint16))
    return str(tmp_path / "KITTI")


def test_sintel_pairs_and_load(sintel_root):
    for split in ("training", "test"):
        kw = dict(split=split, root=sintel_root, dstype="clean")
        ds = tds.MpiSintel(None, **kw)
        assert len(ds) == 3 and ds.is_test == (split == "test")
        _same(ds, jds.MpiSintel(None, **kw))
    s = ds.load(0)
    assert s["image1"].shape == (H, W, 3) and "flow" not in s
    s = tds.MpiSintel(None, root=sintel_root).load(0)
    assert s["flow"].shape == (H, W, 2) and s["valid"].shape == (H, W)
    assert s["valid"].sum() == H * W - 4


def test_chairs_split(chairs_root):
    root, split_file = chairs_root
    for split, n in (("training", 3), ("validation", 1)):
        kw = dict(split=split, root=root, split_file=split_file)
        ds = tds.FlyingChairs(None, **kw)
        assert len(ds) == n
        _same(ds, jds.FlyingChairs(None, **kw))
    with pytest.raises(ValueError, match="unknown FlyingChairs split"):
        tds.FlyingChairs(None, split="test", root=root, split_file=split_file)


def test_kitti_sparse_load(kitti_root):
    for split in ("training", "testing"):
        ds = tds.KITTI(None, split=split, root=kitti_root)
        assert len(ds) == 2 and ds.sparse
        _same(ds, jds.KITTI(None, split=split, root=kitti_root))
    s = tds.KITTI(None, root=kitti_root).load(1)
    assert s["image1"].shape == (H, W, 3)
    assert set(np.unique(s["valid"])) == {0.0, 1.0}


def test_mixing_weights_and_concat(sintel_root, kitti_root):
    def mix(mod):
        sintel = mod.MpiSintel(None, split="training", root=sintel_root,
                               dstype="clean")
        kitti = mod.KITTI(None, split="training", root=kitti_root)
        return 3 * sintel + 2 * kitti + sintel * 1

    got, want = mix(tds), mix(jds)
    assert isinstance(got, tds.ConcatFlowDataset)
    assert len(got) == 3 * 3 + 2 * 2 + 3
    assert got.name == want.name
    _same(got, want)
    np.testing.assert_array_equal(got.load(0)["flow"], got.load(3)["flow"])


def _things_tree(root, dstypes=("frames_cleanpass",)):
    rng = np.random.default_rng(3)
    scene = root / "FlyingThings3D"
    for dstype in dstypes:
        (scene / dstype / "TRAIN/A/0000/left").mkdir(parents=True)
    for d in ("into_future", "into_past"):
        (scene / "optical_flow/TRAIN/A/0000" / d / "left").mkdir(parents=True)
    for i in range(3):
        img = rng.integers(0, 255, size=(H, W, 3), dtype=np.uint8)
        for dstype in dstypes:
            Image.fromarray(img).save(
                scene / dstype / "TRAIN/A/0000/left" / f"{i:04d}.png")
        for d in ("into_future", "into_past"):
            frame_utils.write_pfm(
                str(scene / "optical_flow/TRAIN/A/0000" / d / "left"
                    / f"{i:04d}.pfm"),
                rng.normal(size=(H, W, 3)).astype(np.float32))
    return str(scene)


def _hd1k_tree(root):
    rng = np.random.default_rng(4)
    img_dir = root / "HD1k/hd1k_input/image_2"
    flow_dir = root / "HD1k/hd1k_flow_gt/flow_occ"
    img_dir.mkdir(parents=True)
    flow_dir.mkdir(parents=True)
    for seq in range(2):
        for i in range(3):
            _write_img(img_dir / f"{seq:06d}_{i:04d}.png", rng)
            frame_utils.write_flow_kitti(
                str(flow_dir / f"{seq:06d}_{i:04d}.png"),
                rng.normal(scale=3, size=(H, W, 2)).astype(np.float32))
    return str(root / "HD1k")


def test_flyingthings_directions(tmp_path):
    scene = _things_tree(tmp_path)
    ds = tds.FlyingThings3D(root=scene)
    assert len(ds) == 4
    assert ds.image_list[0][0] == ds.image_list[2][1]
    _same(ds, jds.FlyingThings3D(root=scene))


def test_hd1k_sequence_scan(tmp_path):
    root = _hd1k_tree(tmp_path)
    ds = tds.HD1K(root=root)
    assert len(ds) == 4
    _same(ds, jds.HD1K(root=root))


def test_read_errors_name_the_sample(sintel_root, tmp_path):
    ds = tds.MpiSintel(None, root=sintel_root)
    with open(ds.flow_list[1], "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(tds.SampleReadError,
                       match=r"dataset=MpiSintel split=training sample=1"):
        ds.load(1)


AUG = {"crop_size": (64, 80), "min_scale": -0.2, "max_scale": 0.4,
       "do_flip": True}


def _aug_dataset(mod, cls, request, tmp_path):
    """``cls`` of package ``mod`` on its synthetic tree, augmented."""
    if cls == "MpiSintel":
        return mod.MpiSintel(AUG, root=request.getfixturevalue("sintel_root"))
    if cls == "FlyingChairs":
        root, split = request.getfixturevalue("chairs_root")
        return mod.FlyingChairs(AUG, root=root, split_file=split)
    if cls == "KITTI":
        return mod.KITTI(AUG, root=request.getfixturevalue("kitti_root"))
    if cls == "FlyingThings3D":
        return mod.FlyingThings3D(AUG, root=str(tmp_path / "FlyingThings3D"))
    return mod.HD1K(AUG, root=str(tmp_path / "HD1k"))


def _same_augmented(got, want, seeds=(0, 1, 2)):
    """Equal augmentors, and equal samples under equal generators."""
    parts = lambda d: d.parts if hasattr(d, "parts") else [d]
    assert len(got) == len(want)
    for g, w in zip(parts(got), parts(want)):
        assert (g.name, g.split, len(g), g.sparse) == \
            (w.name, w.split, len(w), w.sparse)
        assert g.image_list == w.image_list and g.flow_list == w.flow_list
        assert type(g.augmentor).__name__ == type(w.augmentor).__name__
        assert dataclasses.asdict(g.augmentor) == \
            dataclasses.asdict(w.augmentor)
    for seed in seeds:
        i = seed * 7 % len(want)
        a = got.load(i, np.random.default_rng(seed))
        b = want.load(i, np.random.default_rng(seed))
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("cls", ["MpiSintel", "FlyingChairs", "KITTI",
                                 "FlyingThings3D", "HD1K"])
def test_augmentation_waits_for_its_slice(cls, request, tmp_path):
    """Augmentation is ported: every dataset built with ``aug_params``
    holds JAX's augmentor (the sparse one for KITTI / HD1K) and loads the
    samples JAX's does under the same generator."""
    _things_tree(tmp_path)
    _hd1k_tree(tmp_path)
    got = _aug_dataset(tds, cls, request, tmp_path)
    want = _aug_dataset(jds, cls, request, tmp_path)
    assert got.augmentor.crop_size == (64, 80)
    assert got.sparse == (cls in ("KITTI", "HD1K"))
    _same_augmented(got, want)
    s = got.load(0, np.random.default_rng(0))
    assert s["image1"].shape == (64, 80, 3) and s["valid"].shape == (64, 80)


# ---------------------------------------------------------------------------
# stage mixtures
# ---------------------------------------------------------------------------

@pytest.fixture
def datasets_root(tmp_path, sintel_root, chairs_root, kitti_root):
    """One ``datasets`` tree with every corpus of every stage (Sintel clean
    and final, both FlyingThings3D passes)."""
    import shutil

    shutil.copytree(tmp_path / "Sintel/training/clean",
                    tmp_path / "Sintel/training/final")
    _things_tree(tmp_path, ("frames_cleanpass", "frames_finalpass"))
    _hd1k_tree(tmp_path)
    return tmp_path


def test_fetch_dataset_chairs_stage(chairs_root):
    root, split_file = chairs_root
    kw = dict(root=str(__import__("pathlib").Path(root).parents[1]),
              split_file=split_file)
    ds = tds.fetch_dataset("chairs", (64, 64), **kw)
    assert len(ds) == 3
    s = ds.load(0, np.random.default_rng(0))
    assert s["image1"].shape == (64, 64, 3)
    assert s["flow"].shape == (64, 64, 2)
    _same_augmented(ds, jds.fetch_dataset("chairs", (64, 64), **kw))


@pytest.mark.parametrize("stage,train_ds,n", [
    ("chairs", "C+T+K+S+H", 3), ("things", "C+T+K+S+H", 8),
    ("sintel", "C+T+K+S+H", 100 * 3 + 100 * 3 + 200 * 2 + 5 * 4 + 4),
    ("sintel", "C+T+K/S", 100 * 3 + 100 * 3 + 4), ("kitti", "C+T+K+S+H", 2)])
def test_fetch_dataset_stage_mixtures_match_jax(datasets_root, stage,
                                                train_ds, n):
    kw = dict(root=str(datasets_root),
              split_file=str(datasets_root / "chairs_split.txt"),
              train_ds=train_ds)
    got = tds.fetch_dataset(stage, (64, 80), **kw)
    want = jds.fetch_dataset(stage, (64, 80), **kw)
    assert len(got) == n
    _same_augmented(got, want, seeds=(0, 5))


def test_fetch_dataset_rejects_unknown_names(datasets_root):
    for stage, train_ds in (("nope", "C+T+K+S+H"), ("sintel", "C+T")):
        with pytest.raises(ValueError, match="unknown"):
            tds.fetch_dataset(stage, (64, 80), root=str(datasets_root),
                              train_ds=train_ds)


# ---------------------------------------------------------------------------
# the sharded loader
# ---------------------------------------------------------------------------

LOADER_AUG = {"crop_size": (48, 64), "min_scale": -0.1, "max_scale": 0.1,
              "do_flip": True}


def test_sharded_loader_batches_and_host_disjointness(sintel_root):
    ds = tds.MpiSintel(LOADER_AUG, split="training", root=sintel_root,
                       dstype="clean")
    loaders = [tds.ShardedLoader(ds, batch_size=1, seed=5, num_hosts=2,
                                 host_id=h, num_workers=2) for h in range(2)]
    idx0 = loaders[0].epoch_indices(0)
    idx1 = loaders[1].epoch_indices(0)
    assert not set(idx0) & set(idx1)
    assert sorted(list(idx0) + list(idx1)) == list(range(len(ds)))
    assert not np.array_equal(loaders[0].epoch_indices(0),
                              loaders[0].epoch_indices(1))
    it = loaders[0].batches()
    batch = next(it)
    assert batch["image1"].shape == (1, 48, 64, 3)
    assert batch["flow"].shape == (1, 48, 64, 2)
    assert batch["valid"].shape == (1, 48, 64)
    for _ in range(3):      # past the epoch boundary
        next(it)


def test_sharded_loader_deterministic(sintel_root):
    ds = tds.MpiSintel(LOADER_AUG, split="training", root=sintel_root,
                       dstype="clean")

    def first_batch():
        return next(tds.ShardedLoader(ds, batch_size=2, seed=9,
                                      num_workers=3).batches())

    b1, b2 = first_batch(), first_batch()
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])


def test_batches_from_step_resumes_shuffle(sintel_root):
    ds = tds.MpiSintel(root=sintel_root)
    mk = lambda: tds.ShardedLoader(ds, batch_size=1, seed=7, num_workers=1)
    spe = mk().steps_per_epoch()
    assert spe == 3
    it = mk().batches()
    full = [next(it) for _ in range(7)]
    it2 = mk().batches_from_step(4)
    resumed = [next(it2) for _ in range(3)]
    for a, b in zip(full[4:], resumed):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("num_hosts,host_id,start", [(1, 0, 0), (2, 1, 3)])
def test_sharded_loader_stream_matches_jax(datasets_root, num_hosts,
                                           host_id, start):
    """The port's loader gives JAX's batches, bit for bit, on an augmented
    stage mixture: the same shuffle, shard, per-sample generators and
    stacking, across an epoch boundary and from a resumed step."""
    kw = dict(root=str(datasets_root),
              split_file=str(datasets_root / "chairs_split.txt"))

    def stream(mod):
        loader = mod.ShardedLoader(mod.fetch_dataset("things", (64, 80), **kw),
                                   batch_size=2, seed=3, num_hosts=num_hosts,
                                   host_id=host_id, num_workers=2)
        it = loader.batches_from_step(start)
        out = [next(it) for _ in range(5)]
        it.close()
        return loader.steps_per_epoch(), out

    (spe, got), (jspe, want) = stream(tds), stream(jds)
    assert spe == jspe
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def _poison_dataset(mod, n=13, poison=(5,)):
    """A synthetic dataset of package ``mod`` whose ``poison`` indices
    fail to read; the others give f(index) plus a generator draw."""

    class Poison(mod.FlowDataset):
        def __init__(self):
            super().__init__()
            self.image_list = [("a", "b")] * n
            self.load_calls = []

        def load(self, index, rng=None):
            self.load_calls.append(index)
            if index in poison:
                raise mod.SampleReadError(f"synth://{index}/a", self, index,
                                          "synthetic corruption")
            base = np.full((8, 10, 3), float(index), np.float32)
            return {"image1": base + rng.standard_normal((8, 10, 3))
                    .astype(np.float32), "image2": base,
                    "flow": np.zeros((8, 10, 2), np.float32),
                    "valid": np.ones((8, 10), np.float32)}

    return Poison()


def test_quarantine_replacement_matches_jax(capsys):
    """A poisoned sample is retried, quarantined and replaced by the index
    JAX draws: the streams stay equal, and so do the counts."""
    out = []
    for mod in (tds, jds):
        ds = _poison_dataset(mod)
        loader = mod.ShardedLoader(ds, batch_size=2, seed=7, num_workers=1,
                                   sample_retries=1)
        it = loader.batches()
        batches = [next(it) for _ in range(6)]     # the whole epoch
        it.close()                                 # joins the pool
        out.append((batches, loader.quarantined_total, ds.load_calls))
    (got, qt, calls), (want, jqt, jcalls) = out
    assert qt == jqt == 1
    assert calls == jcalls and calls.count(5) == 2   # read, then retried
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert "sample quarantined: epoch 0 index 5" in capsys.readouterr().out


def test_corrupt_image_and_worker_err_faults(chairs_root):
    """The ``corrupt_image`` fault fails one sample read, which is
    quarantined and replaced as a real failure is, giving JAX's stream
    under the same fault; ``worker_err`` is not a read error and ends the
    stream."""
    from raft_tpu import chaos as jchaos
    from raft_tpu_torch import chaos

    root, split = chairs_root

    def stream(mod, ch):
        ds = mod.FlyingChairs(LOADER_AUG, root=root, split_file=split)
        ch.install(ch.FaultPlan.parse("corrupt_image@step=1"))
        try:
            loader = mod.ShardedLoader(ds, batch_size=1, seed=1,
                                       num_workers=1, sample_retries=0)
            it = loader.batches()
            out = [next(it) for _ in range(3)]
            it.close()
        finally:
            ch.uninstall()
        return out, loader.quarantined_total

    (got, q), (want, jq) = stream(tds, chaos), stream(jds, jchaos)
    assert q == jq == 1
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    chaos.install(chaos.FaultPlan.parse("worker_err@step=0"))
    try:
        it = tds.ShardedLoader(_poison_dataset(tds, poison=()), 2,
                               num_workers=1).batches()
        with pytest.raises(chaos.InjectedWorkerCrash):
            next(it)
    finally:
        chaos.uninstall()
