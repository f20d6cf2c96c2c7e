"""The port's datasets against the JAX package's (twins of
tests/test_datasets.py) on the same synthetic trees, written with the JAX
package's writers: equal sample lists and equal arrays from ``load(i)``
for every index.  The augmentor and loader tests of that file wait for the
augmentors (ROADMAP A4)."""

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


def test_flyingthings_directions(tmp_path):
    rng = np.random.default_rng(3)
    scene = tmp_path / "FlyingThings3D"
    img_dir = scene / "frames_cleanpass/TRAIN/A/0000/left"
    img_dir.mkdir(parents=True)
    for d in ("into_future", "into_past"):
        (scene / "optical_flow/TRAIN/A/0000" / d / "left").mkdir(parents=True)
    for i in range(3):
        _write_img(img_dir / f"{i:04d}.png", rng)
        for d in ("into_future", "into_past"):
            frame_utils.write_pfm(
                str(scene / "optical_flow/TRAIN/A/0000" / d / "left"
                    / f"{i:04d}.pfm"),
                rng.normal(size=(H, W, 3)).astype(np.float32))
    ds = tds.FlyingThings3D(root=str(scene))
    assert len(ds) == 4
    assert ds.image_list[0][0] == ds.image_list[2][1]
    _same(ds, jds.FlyingThings3D(root=str(scene)))


def test_hd1k_sequence_scan(tmp_path):
    rng = np.random.default_rng(4)
    img_dir = tmp_path / "HD1k/hd1k_input/image_2"
    flow_dir = tmp_path / "HD1k/hd1k_flow_gt/flow_occ"
    img_dir.mkdir(parents=True)
    flow_dir.mkdir(parents=True)
    for seq in range(2):
        for i in range(3):
            _write_img(img_dir / f"{seq:06d}_{i:04d}.png", rng)
            frame_utils.write_flow_kitti(
                str(flow_dir / f"{seq:06d}_{i:04d}.png"),
                rng.normal(scale=3, size=(H, W, 2)).astype(np.float32))
    ds = tds.HD1K(root=str(tmp_path / "HD1k"))
    assert len(ds) == 4
    _same(ds, jds.HD1K(root=str(tmp_path / "HD1k")))


def test_read_errors_name_the_sample(sintel_root, tmp_path):
    ds = tds.MpiSintel(None, root=sintel_root)
    with open(ds.flow_list[1], "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(tds.SampleReadError,
                       match=r"dataset=MpiSintel split=training sample=1"):
        ds.load(1)


@pytest.mark.parametrize("cls", ["MpiSintel", "FlyingChairs", "KITTI",
                                 "FlyingThings3D", "HD1K"])
def test_augmentation_waits_for_its_slice(cls):
    with pytest.raises(NotImplementedError, match="A4.1"):
        getattr(tds, cls)({"crop_size": (64, 64)})
