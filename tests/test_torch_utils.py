"""The command line's libraries in the port against the JAX package's, on
the CPU: the config (``onet_tpu_torch/core/config.py``) and its YAML copy,
the kernel build cache (``core/cache.py``), the parameter and FLOP tables
(``utils/summary.py``) and the profiling tools (``utils/profiling.py``).

Setup: base-8 Onet weights in the JAX package's tree shapes, drawn with numpy
and bridged into the
port (``core/bridge.py::from_jax_numpy``), 32x32 inputs. Tolerances: the
config sections, the statistics, the summary rows and the traced layer
rows equal JAX's exactly (same float32 arrays, numpy's arithmetic on
both sides); the profiler rows carry JAX's keys.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from onet_tpu.core import config as JC
from onet_tpu.models.onet import onet_init as j_onet_init
from onet_tpu.utils import summary as JS

from onet_tpu_torch.core import config as TC
from onet_tpu_torch.core.bridge import from_jax_numpy
from onet_tpu_torch.ops import _build
from onet_tpu_torch.utils import profiling as TP
from onet_tpu_torch.utils import summary as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_YML = os.path.join(REPO, "onet_tpu", "configs", "onet.yml")
HW = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny tensors (several test processes
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[True, False],
                ids=["shared", "twin"])
def weights(request):
    """(JAX params, JAX state, port params, port state) at base 8: JAX's
    tree shapes (``jax.eval_shape``, no compile), numpy draws."""
    shapes = jax.eval_shape(lambda: j_onet_init(
        jax.random.key(0), 1, base=8, weight_share=request.param))
    rng = np.random.default_rng(3)
    draw = lambda s: rng.standard_normal(s.shape).astype(np.float32)  # noqa
    jp, js = (jax.tree.map(draw, t) for t in shapes)
    tp, ts = from_jax_numpy(jp, js, device="cpu")
    return (jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, js),
            tp, ts)


def test_config_yaml_is_the_jax_package_copy():
    with open(JAX_YML, "rb") as a, open(TC.DEFAULT_CONFIG, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("section", ["zy3", "Rayleigh", "naurain"])
def test_generate_config_matches_jax(section):
    argv = ["--enc_in_channels", "32", "--layer_type", "dconv"]
    got = vars(TC.generate_config(TC.DEFAULT_CONFIG, section, argv=argv))
    want = vars(JC.generate_config(JAX_YML, section, argv=argv))
    assert got.pop("device") == "cpu" and got.pop("nocuda") is True
    want.pop("device"), want.pop("nocuda")
    assert got == want
    assert TC.config_to_str(TC.generate_config(
        TC.DEFAULT_CONFIG, section, argv=[])).startswith("Config: -----")


IIC_YML = """
iic:
  model_ind: 570
  mode: IID
  batch_sz: 60
  num_dataloaders: 3
  gt_k: 2
  output_k_A: 10
  output_k_B: 2
  num_epochs: {epochs}
  lr_schedule: [40, 80]
  restart: {restart}
  out_dir: "{out}"
"""


def test_iic_config_and_restart_match_jax(tmp_path, capsys):
    """The legacy IIC path, fresh and restarted from the saved JSON, in
    both packages (each restarts from its own save)."""
    got = {}
    for tag, mod in (("jax", JC), ("port", TC)):
        out = tmp_path / tag
        out.mkdir()
        yml = out / "train_iic.yml"
        yml.write_text(IIC_YML.format(out=out, epochs=100, restart="false"))
        cfg = mod.generate_config(str(yml), "iic")
        cfg.epoch_acc.append(0.5)
        mod.save_config_iic(cfg, str(out))
        yml2 = out / "train_iic2.yml"
        yml2.write_text(IIC_YML.format(out=out, epochs=200, restart="true"))
        cfg2 = mod.generate_config(str(yml2), "iic")
        fresh, again = vars(cfg), vars(cfg2)
        for d in (fresh, again):
            d.pop("device"), d.pop("nocuda"), d.pop("out_dir")
        got[tag] = (fresh, again)
    assert got["port"] == got["jax"]
    assert got["port"][1]["epoch_acc"] == [0.5]
    assert got["port"][1]["num_epochs"] == 200
    assert got["port"][1]["restart"] is True


def test_compilation_cache_honours_env(tmp_path, monkeypatch):
    from onet_tpu_torch.core.cache import enable_compilation_cache

    monkeypatch.setattr(_build, "BUILD", _build.BUILD)
    default = _build.BUILD
    monkeypatch.delenv("ONET_TPU_CACHE_DIR", raising=False)
    assert enable_compilation_cache() == default
    where = str(tmp_path / "kernels")
    monkeypatch.setenv("ONET_TPU_CACHE_DIR", where)
    assert enable_compilation_cache() == where == _build.BUILD
    assert os.path.isdir(where)
    # the build's targets and the tile store's library follow it
    assert _build._target("conv_wp")[1].startswith(where)
    from onet_tpu_torch.data import tilestore
    assert tilestore._lib_path().startswith(where)
    explicit = str(tmp_path / "explicit")
    assert enable_compilation_cache(explicit) == explicit == _build.BUILD


def test_parameter_tables_match_jax(weights):
    jp, _, tp, _ = weights
    assert TS.count_parameters(tp) == JS.count_parameters(jp)
    assert TS.parameter_statistics(tp) == JS.parameter_statistics(jp)
    assert TS.compare_parameter_trees(tp, tp) == [] == \
        JS.compare_parameter_trees(jp, jp)
    # one leaf nudged in both packages: the same names, at each atol
    jq = jax.tree.map(lambda a: a, jp)
    jq["top"]["down2"]["conv1"]["w"] = jp["top"]["down2"]["conv1"]["w"] + 1e-3
    tq = {k: v for k, v in tp.items()}
    tq["top"] = dict(tp["top"], down2=dict(tp["top"]["down2"], conv1={
        "w": torch.tensor(np.asarray(jq["top"]["down2"]["conv1"]["w"]))}))
    for atol in (0.0, 1e-2):
        assert TS.compare_parameter_trees(tp, tq, atol=atol) == \
            JS.compare_parameter_trees(jp, jq, atol=atol)
    assert TS.compare_parameter_trees(tp, tq) == ["top/down2/conv1/w"]


@pytest.mark.parametrize("hw,cin,batch", [((32, 32), 1, 1),
                                          ((224, 224), 1, 2),
                                          ((48, 40), 3, 1)])
def test_model_summary_matches_jax(weights, hw, cin, batch):
    jp, _, tp, _ = weights
    assert TS.model_summary(tp, input_hw=hw, in_channels=cin,
                            batch=batch) == \
        JS.model_summary(jp, input_hw=hw, in_channels=cin, batch=batch)


@pytest.mark.parametrize("shape", [(2, HW, HW, 1), (1, 50, 50, 1)])
def test_runtime_layer_summary_matches_jax(weights, shape):
    jp, js, tp, ts = weights
    got = TS.runtime_layer_summary(tp, ts, torch.zeros(shape))
    want = JS.runtime_layer_summary(jp, js, jnp.zeros(shape, jnp.float32))
    assert got == want
    nets = 1 if "down" not in tp else 2
    assert [r["op"] for r in got].count("conv3x3") == 18 * nets


def test_profiling_rows_carry_jax_keys(tmp_path):
    keys = {"name", "category", "total_ms", "occurrences", "gflops_per_s",
            "bw_gib_per_s", "bound_by"}
    x = torch.randn(64, 64)
    f = lambda v: torch.tanh(v) @ torch.tanh(v).T   # noqa: E731
    timer = TP.StepTimer("cpu")
    with TP.trace(str(tmp_path)) as logdir:
        y = f(x)
        assert TP.StepTimer.sync({"b": y, "a": x}) == float(x[0, 0])
    assert timer.stop(y, steps=2) > 0
    rows = TP.hlo_breakdown(logdir, top=5)
    assert rows and all(set(r) == keys for r in rows)
    assert rows == sorted(rows, key=lambda r: -r["total_ms"])
    assert {r["category"] for r in rows} == {"host"}   # no device here
    cats = TP.category_breakdown(logdir)
    assert set(cats) == {"host"} and cats["host"] > 0
    assert TP.hlo_breakdown(str(tmp_path / "none")) == []


@pytest.mark.parametrize("name,category", [
    ("void conv_wp_bf16_1in(Args)", "hand-written"),
    ("stats_reduce_ranges(float const*, float*, float*, int)",
     "hand-written"),
    ("void minmax_cluster<float>(float const*, float*)", "hand-written"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "cudnn/cublas"),
    ("Memcpy DtoH (Device -> Pinned)", "copy"),
    ("void at::native::reduce_kernel<512, 1>(...)", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>(...)",
     "elementwise"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc",
     "other"),
])
def test_kernel_categories(name, category):
    assert "conv_wp_bf16_1in" in TP.hand_written_kernels()
    assert TP.kernel_category(name) == category
