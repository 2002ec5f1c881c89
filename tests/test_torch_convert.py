"""Weight bridge: a flax variable tree of the reference loads into the port
with ``strict=True``, every leaf accounted for and carried over exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pasco_tpu.core.config import tiny_config
from pasco_torch.convert import flax_to_torch
from pasco_torch.models.unet import build_net

torch.set_num_threads(1)


def tiny_f32_config(n_infers=1):
    cfg = tiny_config(n_infers=n_infers)
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))


def flatten(variables):
    """A flax variable tree as ``params/a/b`` / ``batch_stats/a/b`` numpy leaves."""
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]
    }


def nest(flat):
    out = {}
    for key, leaf in flat.items():
        d = out
        *path, name = key.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[name] = leaf
    return out


def perturbed(flat, seed):
    """Seeded noise on every leaf; BN variances stay positive, so no
    BatchNorm is the identity."""
    r = np.random.RandomState(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("/var"):
            out[k] = (v * r.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        elif k.endswith("/mean") or k.endswith("/bias"):
            out[k] = (v + 0.05 * r.randn(*v.shape)).astype(np.float32)
        elif k.endswith("/scale"):
            out[k] = (v * r.uniform(0.8, 1.2, v.shape)).astype(np.float32)
        else:
            out[k] = (v * r.uniform(0.9, 1.1, v.shape)).astype(np.float32)
    return out


def init_reference(cfg, inp):
    from test_model_forward import labelweights

    from pasco_tpu.models.dense_unet import DensePaSCoNet

    net = DensePaSCoNet(cfg)
    lw = labelweights(cfg)
    variables = jax.jit(
        lambda i: net.init({"params": jax.random.PRNGKey(0)}, i, lw, train=False)
    )(inp)
    return net, lw, variables


@pytest.fixture(scope="module")
def reference_flat():
    from test_model_forward import make_input

    cfg = tiny_f32_config()
    _, _, variables = init_reference(cfg, make_input(cfg, rng=0))
    return perturbed(flatten(variables), seed=1)


def test_flax_tree_loads_strict(reference_flat):
    net = build_net(tiny_f32_config(), device="cpu")
    sd = flax_to_torch(reference_flat)
    assert set(sd) == set(net.state_dict()), (
        sorted(set(sd) ^ set(net.state_dict()))[:10])
    net.load_state_dict(sd, strict=True)
    got = {k: v.numpy() for k, v in net.state_dict().items()}
    for key, leaf in reference_flat.items():
        coll, *path, name = key.split("/")
        tk = ".".join(path + [name])
        if name == "kernel" and leaf.ndim == 2:
            np.testing.assert_array_equal(got[".".join(path + ["weight"])], leaf.T)
        elif name == "scale" and path[-1] in ("norm", "decoder_norm"):
            np.testing.assert_array_equal(got[".".join(path + ["weight"])], leaf)
        else:
            np.testing.assert_array_equal(got[tk], leaf)


def test_flax_tree_keeps_reference_shapes(reference_flat):
    sd = flax_to_torch(reference_flat)
    assert sd["enc_s1.res0.conv1.kernel"].shape == (27, 16, 16)
    assert sd["enc_s2.down.kernel"].shape == (8, 16, 32)
    assert sd["dec_s1.up_kernel"].shape == (8, 32, 16)
    assert sd["dec_s1.resize.kernel"].shape == (1, 19, 16)
    assert sd["voxel_feats_s1.conv1.kernel"].shape == (1, 27, 16, 16)
    assert sd["voxel_feats_s4.bn.mean"].shape == (1, 64)
    assert sd["transformer.cross_0.q_proj.weight"].shape == (48, 48)
    assert sd["transformer.mask_embed.Dense_2.weight"].shape == (48, 48)
    assert sd["transformer.query_feat"].shape == (1, 10, 48)
    assert sd["bottleneck.a4_conv.kernel"].shape == (7, 7, 5, 64, 64)


def test_flax_to_torch_key_rules():
    flat = {
        "params/fc/kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
        "params/blk/norm/scale": np.ones(3, np.float32),
        "params/blk/bn/scale": np.full(3, 2.0, np.float32),
        "batch_stats/blk/bn/var": np.full(3, 3.0, np.float32),
        "params/conv/kernel": np.zeros((27, 2, 3), np.float32),
    }
    sd = flax_to_torch(flat)
    assert sorted(sd) == ["blk.bn.scale", "blk.bn.var", "blk.norm.weight",
                          "conv.kernel", "fc.weight"]
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), flat["params/fc/kernel"].T)
    with pytest.raises(KeyError):
        flax_to_torch({"cache/x/kernel": np.zeros(1, np.float32)})


def test_seeded_init_matches_reference_families():
    """The port's own init (used on the card, where there is no JAX):
    same families and scales as the flax initializers."""
    cfg = tiny_f32_config()
    a = build_net(cfg, device="cpu")
    b = build_net(cfg, device="cpu")
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    sd = a.state_dict()
    w = sd["enc_s1.res0.conv1.kernel"]
    bound = (1.0 / (27 * 16)) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert torch.all(sd["dec_s1.res0.bn1.var"] == 1) and torch.all(sd["dec_s1.res0.bn1.scale"] == 1)
    assert torch.all(sd["dec_s1.up_bias"] == 0)
    lin = sd["transformer.class_embed.weight"]        # lecun normal, fan_in 48
    assert abs(lin.std().item() - (1 / 48) ** 0.5) < 0.03
    q = sd["transformer.query_feat"]
    assert abs(q.std().item() - 1.0) < 0.2
