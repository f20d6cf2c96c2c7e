"""The port's weight bridge: flax <-> port state_dict round trip, and the
reference ``.pth`` key map held against the JAX package's own."""

import re

import jax
import numpy as np
import pytest
import torch

from raft_tpu.convert import convert_state_dict
from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.convert import (flax_from_state_dict, load_reference_pth,
                                    load_state_dict_file,
                                    state_dict_from_flax, template_shapes)

from test_torch_fixtures import full_raft_variables, small_raft_variables


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _reference_state_dict(variables):
    """Reference-format keys built from the flax tree, independently of
    both converters: ``module.`` prefix, ``layerX.Y``, ``downsample.0``
    plus its ``downsample.1`` norm alias, ``update_block.mask.0/2``,
    separate ``convz*``/``convr*`` gates, OIHW kernels, batch counters."""
    out = {}

    def put(key, arr):
        out["module." + key] = torch.from_numpy(np.ascontiguousarray(arr))

    for path, arr in _leaves(variables["params"]).items():
        parts = re.findall(r"\['([^']+)'\]", path)
        leaf = parts[-1]
        mods = [p for p in parts[:-1] if p not in ("BatchNorm_0",)]
        if mods[0] == "refine":
            mods = mods[1:]
        if mods[:2] == ["upsampler", "mask_head"]:
            mods = ["update_block", "mask",
                    {"mask_conv1": "0", "mask_conv2": "2"}[mods[2]]]
        mods = [re.sub(r"^(layer\d)_(\d)$", r"\1.\2", m) for m in mods]
        mods = ".".join(mods).replace("downsample_conv", "downsample.0")
        mods = mods.split(".")
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        m = re.fullmatch(r"convzr(\d*)", mods[-1])
        if m:
            half = arr.shape[0] // 2
            stem = ".".join(mods[:-1])
            put(f"{stem}.convz{m.group(1)}.{name}", arr[:half])
            put(f"{stem}.convr{m.group(1)}.{name}", arr[half:])
            continue
        put(".".join(mods) + "." + name, arr)
        if mods[-1] == "norm3":      # the reference's downsample.1 alias
            put(".".join(mods[:-1]) + ".downsample.1." + name, arr)
    for path, arr in _leaves(variables["batch_stats"]).items():
        parts = re.findall(r"\['([^']+)'\]", path)
        mods = [re.sub(r"^(layer\d)_(\d)$", r"\1.\2", m)
                for m in parts[:-2]]
        stat = {"mean": "running_mean", "var": "running_var"}[parts[-1]]
        put(".".join(mods) + "." + stat, arr)
        out["module." + ".".join(mods) + ".num_batches_tracked"] = \
            torch.tensor(7)
        if mods[-1] == "norm3":
            put(".".join(mods[:-1]) + ".downsample.1." + stat, arr)
    return out


def test_flax_roundtrip_is_bit_exact():
    variables, _ = full_raft_variables(0)
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(template_shapes())
    back = _leaves(flax_from_state_dict(sd))
    want = _leaves(variables)
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_every_leaf_consumed_and_checked():
    variables, sd = full_raft_variables(0)
    # HWIO -> OIHW on a non-square kernel, z first in the fused gate conv
    k = variables["params"]["refine"]["update_block"]["gru"]["convzr1"][
        "kernel"]
    w = sd["refine.update_block.gru.convzr1.weight"].numpy()
    assert k.shape == (1, 5, 384, 256) and w.shape == (256, 384, 1, 5)
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["cnet.norm1.running_var"].numpy(),
        variables["batch_stats"]["cnet"]["norm1"]["BatchNorm_0"]["var"])
    # a missing or an extra leaf is refused, not ignored
    params = dict(variables["params"])
    del params["fnet"]
    with pytest.raises(ValueError, match="missing"):
        state_dict_from_flax({"params": params,
                              "batch_stats": variables["batch_stats"]})
    extra = dict(variables["params"], stray={"kernel": np.zeros(
        (1, 1, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        state_dict_from_flax({"params": extra,
                              "batch_stats": variables["batch_stats"]})


def test_reference_keys_map_back_in_both_packages(tmp_path):
    variables, sd = full_raft_variables(0)
    ref = _reference_state_dict(variables)

    # the JAX package's own key map recovers the original tree...
    template = {"params": variables["params"],
                "batch_stats": variables["batch_stats"]}
    jax_tree = convert_state_dict(ref, template)
    got, want = _leaves(jax_tree), _leaves(variables)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # ...and the port's own copy of it gives the port's state_dict
    path = tmp_path / "reference.pth"
    torch.save(ref, path)
    port = load_reference_pth(str(path))
    assert set(port) == set(sd)
    for k in sd:
        assert torch.equal(port[k], sd[k]), k

    # the demo's loader takes either format
    own = tmp_path / "own.pth"
    torch.save(sd, own)
    for p in (path, own):
        loaded = load_state_dict_file(str(p), RAFTConfig.full())
        assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_small_preset_roundtrip_and_reference_keys(tmp_path):
    """The small model through every function of the bridge: the flax
    round trip bit for bit, the template's shapes (ConvGRU's ``convzr``
    double-width 3x3, ``convc1`` on 196 taps), the reference key map of
    both packages (``convz``/``convr`` with no digit suffix merged into
    ``convzr``), and the loader on either format."""
    small = RAFTConfig.small_model()
    variables, sd = small_raft_variables(0)
    shapes = template_shapes(small)
    assert set(sd) == set(shapes) and len(shapes) == 104
    assert shapes["refine.update_block.gru.convzr.weight"] == (192, 242, 3, 3)
    assert shapes["refine.update_block.encoder.convc1.weight"] == (96, 196,
                                                                   1, 1)
    assert not any(k.startswith("upsampler") for k in shapes)
    back = _leaves(flax_from_state_dict(sd))
    want = _leaves(variables)
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k

    ref = _reference_state_dict(variables)
    assert "module.update_block.gru.convz.weight" in ref
    assert "module.update_block.gru.convr.bias" in ref
    jax_tree = convert_state_dict(ref, {"params": variables["params"],
                                        "batch_stats": {}})
    got = _leaves(jax_tree)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = tmp_path / "reference_small.pth"
    torch.save(ref, path)
    port = load_reference_pth(str(path), small)
    assert set(port) == set(sd)
    assert all(torch.equal(port[k], sd[k]) for k in sd)
    own = tmp_path / "own_small.pth"
    torch.save(sd, own)
    for p in (path, own):
        loaded = load_state_dict_file(str(p), small)
        assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    # a full model's file is refused for the small preset, not half-read
    _, full_sd = full_raft_variables(0)
    torch.save(full_sd, tmp_path / "full.pth")
    with pytest.raises(ValueError, match="missing|unexpected"):
        load_state_dict_file(str(tmp_path / "full.pth"), small)
