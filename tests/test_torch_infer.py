"""The port's BN-folded serving path (onet_tpu_torch) against the JAX
package on the same weights and inputs, on the CPU.

Weights come from the JAX init and cross through the port's bridge; frames
come from a numpy seed. fp32 contract: S within atol 2e-5 / rtol 1e-4
(float32 reassociation through ~20 conv layers) and labels equal wherever
the two classes are separated by more than 1e-4 (closer pixels may flip on
that same noise). The pair-packed branch runs JAX's Pallas kernels in
interpret mode and the port's plain versions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import onet_tpu.ops.pallas_conv as PC
from onet_tpu.core.policy import DEFAULT as J_DEFAULT, BF16_COMPUTE as J_BF16
from onet_tpu.core.torch_import import export_torch_state
from onet_tpu.models.infer import fold_onet as j_fold, onet_infer as j_infer
from onet_tpu.models.onet import onet_init as j_init

from onet_tpu_torch.core.bridge import from_jax_numpy, import_torch_state
from onet_tpu_torch.core.policy import DEFAULT, BF16_COMPUTE
from onet_tpu_torch.models.infer import fold_onet, onet_infer
from onet_tpu_torch.models.unet import tree_leaves

S_TOL = dict(atol=2e-5, rtol=1e-4)


def _np_tree(t):
    return jax.tree.map(lambda a: np.array(a, copy=True), t)


def _jax_model(seed, *, base, weight_share=True):
    """JAX (params, state) trees with the structure of ``onet_init`` (taken
    by ``jax.eval_shape``, nothing compiled) and leaves drawn with numpy:
    Kaiming-scaled weights, non-trivial BN affine and running stats, so
    folding is exercised."""
    shapes = jax.eval_shape(lambda: j_init(
        jax.random.key(seed), 1, base=base, weight_share=weight_share))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "w":
            a = rng.standard_normal(s.shape) * np.sqrt(
                2.0 / np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, s.shape)
        else:                                   # bias, b, mean
            a = 0.1 * rng.standard_normal(s.shape)
        return jnp.asarray(a.astype(np.float32))

    return tuple(jax.tree_util.tree_map_with_path(draw, t) for t in shapes)


def _frames(b, h, w, seed=3):
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 1)).astype(
        np.float32)


def _check_s(s_port, labels_port, s_jax, labels_jax):
    s_port, s_jax = np.asarray(s_port), np.asarray(s_jax)
    np.testing.assert_allclose(s_port, s_jax, **S_TOL)
    sep = np.abs(s_jax[..., 0] - s_jax[..., 1]) > 1e-4
    np.testing.assert_array_equal(np.asarray(labels_port)[sep],
                                  np.asarray(labels_jax)[sep])


def test_from_jax_numpy_round_trip_bit_exact():
    params, state = _jax_model(0, base=8)
    tp, ts = from_jax_numpy(_np_tree(params), _np_tree(state), device="cpu")
    for tree_j, tree_t in ((params, tp), (state, ts)):
        leaves_j = jax.tree_util.tree_flatten_with_path(tree_j)[0]
        assert len(leaves_j) == len(tree_leaves(tree_t))
        for path, leaf in leaves_j:
            node = tree_t
            for p in path:
                node = node[p.key]
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_fold_onet_matches_jax():
    params, state = _jax_model(1, base=8, weight_share=False)
    tp, ts = from_jax_numpy(_np_tree(params), _np_tree(state), device="cpu")
    fj = j_fold(params, state)
    ft = fold_onet(tp, ts)
    for path, leaf in jax.tree_util.tree_flatten_with_path(fj)[0]:
        node = ft
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   rtol=1e-6, atol=1e-7)


CASES = {
    "stacked": dict(size=32, opts={}),
    "stacked_dp_local": dict(size=32, opts=dict(dp_local=True)),
    "batch_stacked": dict(size=32, opts=dict(channel_stack=False)),
    "twin": dict(size=32, opts={}, weight_share=False),
    "odd_30x30": dict(size=30, opts={}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_onet_infer_fp32_matches_jax(case):
    cfg = CASES[case]
    params, state = _jax_model(2, base=8,
                               weight_share=cfg.get("weight_share", True))
    x = _frames(2, cfg["size"], cfg["size"])
    s_j, l_j = j_infer(j_fold(params, state), jnp.asarray(x),
                       policy=J_DEFAULT, **cfg["opts"])
    tp, ts = from_jax_numpy(_np_tree(params), _np_tree(state), device="cpu")
    s_t, l_t = onet_infer(fold_onet(tp, ts), torch.tensor(x),
                          policy=DEFAULT, **cfg["opts"])
    assert s_t.shape == (2, cfg["size"], cfg["size"], 2)
    assert s_t.dtype == torch.float32
    _check_s(s_t.numpy(), l_t.numpy(), s_j, l_j)


@pytest.fixture(scope="module")
def wp_case():
    """Base 64 (the wp geometry), B=2, 32x32: the JAX wp path in interpret
    mode, once per module."""
    params, state = _jax_model(4, base=64)
    x = _frames(2, 32, 32, seed=5)
    old = PC.INTERPRET
    PC.INTERPRET = True
    try:
        s_j, l_j = j_infer(j_fold(params, state), jnp.asarray(x),
                           policy=J_DEFAULT, pair_pack=True)
    finally:
        PC.INTERPRET = old
    tp, ts = from_jax_numpy(_np_tree(params), _np_tree(state), device="cpu")
    return fold_onet(tp, ts), x, np.asarray(s_j), np.asarray(l_j)


def test_onet_infer_wp_fp32_matches_jax(wp_case):
    folded, x, s_j, l_j = wp_case
    s_t, l_t = onet_infer(folded, torch.tensor(x), policy=DEFAULT,
                          pair_pack=True)
    _check_s(s_t.numpy(), l_t.numpy(), s_j, l_j)


def test_onet_infer_wp_bf16_mask_agreement(wp_case):
    """bf16 rounds at other places than f32: masks agree on >= 99% of
    pixels, against the JAX fp32 wp result and the port's own stacked
    bf16 path."""
    folded, x, _, l_j = wp_case
    _, l_wp = onet_infer(folded, torch.tensor(x), policy=BF16_COMPUTE,
                         pair_pack=True)
    _, l_st = onet_infer(folded, torch.tensor(x), policy=BF16_COMPUTE,
                         pair_pack=False)
    assert float((l_wp.numpy() == l_j).mean()) >= 0.99
    assert float((l_wp == l_st).float().mean()) >= 0.99


def test_onet_infer_bf16_stacked_agrees_with_jax_bf16():
    params, state = _jax_model(6, base=8)
    x = _frames(2, 32, 32, seed=6)
    _, l_j = j_infer(j_fold(params, state), jnp.asarray(x), policy=J_BF16)
    tp, ts = from_jax_numpy(_np_tree(params), _np_tree(state), device="cpu")
    s_t, l_t = onet_infer(fold_onet(tp, ts), torch.tensor(x),
                          policy=BF16_COMPUTE)
    assert s_t.dtype == torch.float32
    assert float((l_t.numpy() == np.asarray(l_j)).mean()) >= 0.99


@pytest.mark.parametrize("weight_share", [True, False])
def test_reference_state_dict_import_serves_same_s(weight_share):
    params, state = _jax_model(7, base=8, weight_share=weight_share)
    sd = export_torch_state(params, state)
    tp, ts = import_torch_state({k: torch.from_numpy(v) for k, v in
                                 sd.items()}, device="cpu")
    assert ("down" in tp) == (not weight_share)
    x = _frames(2, 32, 32, seed=8)
    s_j, l_j = j_infer(j_fold(params, state), jnp.asarray(x),
                       policy=J_DEFAULT)
    s_t, l_t = onet_infer(fold_onet(tp, ts), torch.tensor(x),
                          policy=DEFAULT)
    _check_s(s_t.numpy(), l_t.numpy(), s_j, l_j)


def test_import_torch_state_rejects_foreign_dict():
    with pytest.raises(KeyError):
        import_torch_state({"fc.weight": torch.zeros(2)}, device="cpu")


@pytest.mark.parametrize("weight_share", [True, False])
def test_load_onet_npz_reads_jax_checkpoint(tmp_path, weight_share):
    from onet_tpu.core.checkpoint import save_checkpoint
    from onet_tpu_torch.core.bridge import load_onet_npz

    params, state = _jax_model(9, base=8, weight_share=weight_share)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params, state, epoch=3)
    tp, ts, epoch = load_onet_npz(path, device="cpu")
    assert epoch == 3
    ep, es = from_jax_numpy(_np_tree(params), _np_tree(state), device="cpu")
    for got, want in ((tp, ep), (ts, es)):
        a, b = tree_leaves(got), tree_leaves(want)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.numpy(), v.numpy())


def test_load_onet_npz_rejects_wrong_shape(tmp_path):
    from onet_tpu.core.checkpoint import save_checkpoint
    from onet_tpu_torch.core.bridge import load_onet_npz

    params, state = _jax_model(9, base=8)
    params["top"]["up1"]["up"]["b"] = jnp.zeros(3)
    path = str(tmp_path / "bad.npz")
    save_checkpoint(path, params, state, epoch=0)
    with pytest.raises(ValueError):
        load_onet_npz(path, device="cpu")
