"""The port's collective recorder and step projection
(``onet_tpu_torch/parallel/collectives.py::record``,
``onet_tpu_torch/utils/projection.py``): the counterpart of
tests/test_projection.py, where JAX parses compiled HLO text.

The pricing is held against the JAX package's own
``onet_tpu/utils/projection.py`` on the same collectives: each port
``Collective`` becomes JAX's ``Collective(kind, payload_bytes,
group_size, name)``, and ``wire_bytes``, ``summarize`` and
``project_step`` (JAX's with ``axis_bw=NVLINK_BW``,
``latency_s=NVLINK_LATENCY``) must give the port's results, on
hand-made collectives and on recorded steps. A collective the port's
recorder notes once an execution is, on JAX's side, one ``in_loop``
collective priced ``loop_trips`` times (A5). The recorder is held on
collectives of known payload (a psum of f32[128] and its gradient's), on
the data-parallel train step (its gradient all-reduce carries one
float32 per parameter and the loss; no activation moves), on the
pipeline (one activation transfer a microbatch each way) and on ``serve
--dp`` (no collective). Ranks: one gloo world of 2 CPU processes
(tests/torch_parallel_worker.py), base 8, 32x32 frames.
"""

import numpy as np
import pytest
import torch

from onet_tpu.utils import projection as J
from onet_tpu_torch.utils.projection import (NVLINK_BW, NVLINK_LATENCY,
                                             Collective, project_step,
                                             rescale, summarize)

from torch_parallel_worker import World

X = np.random.default_rng(0).uniform(0, 1, (4, 32, 32, 1)).astype(
    np.float32)
D, DST = ("data", "space"), ("data", "stage")
# one of each kind, a group of one among them
HAND = [Collective("all-reduce", 4096, 8, "grads"),
        Collective("all-gather", 2048, 2, "all_gather"),
        Collective("reduce-scatter", 64, 4, "psum_scatter"),
        Collective("collective-permute", 8192, 2, "halo"),
        Collective("all-reduce", 128, 1, "bn_sums")]


def _jax(cols, loop=()):
    """The JAX package's Collective of each port one; names in ``loop``
    are inside a loop body (``in_loop``)."""
    return [J.Collective(c.kind, c.payload_bytes, c.group_size, c.name,
                         in_loop=c.name in loop) for c in cols]


def _jax_project(t, cols, tiles, loop=(), trips=1,
                 latency=NVLINK_LATENCY):
    """JAX's ``project_step`` on the port's collectives, priced for NVLink.
    The executions of a collective named in ``loop`` (the port's recorder
    notes each) are one loop-body collective of JAX's, run ``trips``
    times."""
    seen, once = set(), []
    for c in cols:
        if c.name in loop:
            if c.name in seen:
                continue
            seen.add(c.name)
        once.append(c)
    return J.project_step(t, _jax(once, loop), tiles_per_step=tiles,
                          loop_trips=trips, axis_bw=NVLINK_BW,
                          latency_s=latency)


def _same_projection(got, want, n_port=None):
    """The port's record equals JAX's key for key (floats to rounding:
    JAX multiplies a loop body's time by its trips, the port sums the
    executions); ``n_port``: the port's count of executions, where JAX
    counts a loop body's collective once."""
    assert set(got) == set(want)
    for k in got:
        if k == "n_collectives" and n_port is not None:
            assert got[k] == n_port
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, str(tmp_path_factory.mktemp("proj_world")))
    yield w
    w.close()


def test_wire_bytes_and_summary():
    """JAX's ring volumes (A2) for each kind, and its per-kind totals."""
    assert [c.wire_bytes() for c in HAND] == [c.wire_bytes()
                                              for c in _jax(HAND)]
    assert summarize(HAND) == J.summarize(_jax(HAND))
    assert HAND[-1].wire_bytes() == 0.0        # a group of one moves none


@pytest.mark.parametrize("latency", [0.0, NVLINK_LATENCY])
def test_project_step_matches_jax(latency):
    """``project_step`` gives JAX's record on the same collectives, priced
    for NVLink; a pipeline trip that ran 4 times is 4 records here and one
    loop-body collective of 4 trips there (A5)."""
    got = project_step(1e-3, HAND, tiles_per_step=10, latency_s=latency)
    want = J.project_step(1e-3, _jax(HAND), tiles_per_step=10,
                          axis_bw=NVLINK_BW, latency_s=latency)
    assert got == want
    cols = ([Collective("all-reduce", 4.5e8, 8, "grads")]
            + [Collective("collective-permute", 4.5e8, 2, "stage")] * 4)
    got = project_step(1e-3, cols, tiles_per_step=10, latency_s=latency)
    _same_projection(got, _jax_project(1e-3, cols, 10, loop={"stage"},
                                       trips=4, latency=latency), n_port=5)
    assert 0 < got["ici_fraction"] < 1


def test_rescale_to_a_larger_mesh():
    """Gradient, BatchNorm and scale payloads keep their bytes; an
    activation's scale with the frames and the element size; each group
    spans the larger mesh's axes it was issued over (A7)."""
    cols = [Collective("all-reduce", 1000, 2, "grads", ("data", "space"),
                       4),
            Collective("all-reduce", 64, 2, "bn_sums",
                       ("data", "space", "spacew"), 4),
            Collective("collective-permute", 400, 2, "halo", ("space",), 4),
            Collective("all-reduce", 4, 2, "quant_max", ("data",), 4)]
    got = rescale(cols, {"data": 4, "space": 2}, frames=4.0, elem_bytes=2)
    assert [(c.payload_bytes, c.group_size, c.elem_bytes) for c in got] == [
        (1000, 8, 4), (64, 8, 4), (800, 2, 2), (4, 4, 4)]


def test_psum_known_payload(world):
    """A psum of f32[128] over 2 ranks: one all-reduce of 512 bytes in the
    forward, one in the backward, both over the 2-rank group."""
    x = np.ones((2, 128), np.float32)
    out = world.run("record", what="psum", shape=(2, 1), names=D,
                    ranks=[0, 1], x=x)
    for cols in out:
        assert [(c.kind, c.payload_bytes, c.group_size, c.name)
                for c in cols] == [("all-reduce", 512, 2, "psum"),
                                   ("all-reduce", 512, 2, "psum.grad")]


def test_dp_step_collectives_cover_gradient_bytes(world):
    """The data-parallel step (data 2): one gradient all-reduce of one
    float32 per parameter and the loss, over the whole mesh; everything
    else BatchNorm sums; no activation gathered, permuted or scattered."""
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.models.unet import tree_leaves

    p, _ = onet_init(torch.Generator().manual_seed(0), 1, base=8,
                     device="cpu")
    n = sum(t.numel() for t in tree_leaves(p))
    out = world.run("record", what="dp", shape=(2, 1), names=D,
                    ranks=[0, 1], x=X)
    cols = out[0]
    assert {c.kind for c in cols} == {"all-reduce"}
    grads = [c for c in cols if c.name == "grads"]
    assert len(grads) == 1 and grads[0].payload_bytes == 4 * (n + 1)
    assert grads[0].axes == D and grads[0].group_size == 2
    assert {c.name for c in cols} == {"grads", "bn_sums"}
    bn = sum(c.payload_bytes for c in cols if c.name == "bn_sums")
    assert bn < grads[0].payload_bytes
    assert [c.payload_bytes for c in out[1]] == [c.payload_bytes
                                                 for c in cols]
    assert summarize(cols) == J.summarize(_jax(cols))
    assert project_step(0.2, cols, tiles_per_step=4) == J.project_step(
        0.2, _jax(cols), tiles_per_step=4, axis_bw=NVLINK_BW,
        latency_s=NVLINK_LATENCY)


@pytest.mark.parametrize("m", [2, 4])
def test_pipeline_trips_counted(world, m):
    """The pipeline (stage 2) with m microbatches: the stage activations
    cross once a microbatch forward and once back (each execution noted),
    and the gradients meet in one all-reduce. Priced, the m executions
    are JAX's one loop-body collective of m trips."""
    out = world.run("record", what="pp", shape=(1, 2), names=DST,
                    ranks=[0, 1], x=X, microbatches=m)
    for cols in out:
        names = [c.name for c in cols]
        assert names.count("stage_activations") == m
        assert names.count("stage_activations.grad") == m
        assert names.count("grads") == 1
        fwd = [c for c in cols if c.name == "stage_activations"]
        assert len({c.payload_bytes for c in fwd}) == 1
        assert all(c.kind == "collective-permute" and c.group_size == 2
                   for c in fwd)
        loop = {"stage_activations", "stage_activations.grad"}
        _same_projection(project_step(0.2, cols, tiles_per_step=4),
                         _jax_project(0.2, cols, 4, loop=loop, trips=m),
                         n_port=len(cols))


def test_serve_dp_issues_no_collective(world, tmp_path):
    """``serve --dp 2`` in a world of 2 processes: each shard runs the
    whole per-frame graph, so no collective runs (JAX's shard_map serving
    compiles to none)."""
    from onet_tpu_torch.core.checkpoint import save_checkpoint
    from onet_tpu_torch.models.onet import onet_init

    p, s = onet_init(torch.Generator().manual_seed(5), 1, base=8,
                     device="cpu")
    ck = str(tmp_path / "ck_epoch_1.npz")
    save_checkpoint(ck, p, s, 1)
    frames = str(tmp_path / "frames.npz")
    np.savez(frames, imgs=X[:3])
    out = world.run("record", what="command", shape=(2, 1), names=D,
                    ranks=[0, 1], argv=["serve", "--model", ck, "--input",
                                        frames, "--serve-batch", "3",
                                        "--dp", "2", "--out",
                                        str(tmp_path / "masks.npz"),
                                        "--device", "cpu"])
    assert out == [[], []]
