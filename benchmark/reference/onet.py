"""Plain float32 reference of the Onet: a weight-shared twin U-Net, its
JSD head and loss, the train step with Adam, and the BatchNorm-folded
eval forward. PyTorch operations only, NCHW, with TF32 off; it imports
nothing of the program.

The model, from the Onet paper's ``Onet_vanilla_20240606.py``: a U-Net
of widths base x (1, 2, 4, 8, 16) returns its first DoubleConv's output L
(local features) and its last decoder output H (global features). The
twin runs it on X and on the complement X_d = clip(1 - X, 0, 1), each
branch with its own BatchNorm statistics (top first, then down, each
updating the running statistics in that order). V_b = <L_b, H_b> over
channels, S = softmax([V_t, V_d]), and the loss is -(jsd_t + jsd_d) / 2
with jsd(l, s, s') = -mean(softplus(-l s)) - mean(softplus(l s')), l the
channel sum of a branch's L.

Weights come in the port's tree (HWIO conv weights under "top"); they are
inputs that the benchmark makes, not anything the program derived.
Training recomputes each block in the backward pass (activation
checkpointing), so that a batch of 24 at 512^2 fits in float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5
MOMENTUM = 0.1
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuDNN and cuBLAS inside the block."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def conv3(x, w_hwio, b=None, cast=None):
    """3x3 SAME conv; ``cast`` rounds both operands first (a control)."""
    if cast is not None:
        x, w_hwio = cast(x), cast(w_hwio)
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b, padding=1)


def fp8_e4m3(t):
    """t rounded to float8 e4m3 under a per-tensor scale (its max |t| to
    e4m3's 448), back in t's type: the operands of an fp8 conv."""
    s = torch.clamp(t.abs().amax() / 448.0, min=1e-30)
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def convT(x, w_hwio, b, cast=None):
    """y[n, o, 2i+di, 2j+dj] = sum_c x[n, c, i, j] w[di, dj, c, o] + b[o]."""
    if cast is not None:
        x, w_hwio = cast(x), cast(w_hwio)
    n, _, h, w = x.shape
    y = torch.einsum("nchw,klco->nohkwl", x, w_hwio)
    return y.reshape(n, w_hwio.shape[3], 2 * h, 2 * w) + b.view(1, -1, 1, 1)


def pad_to(y, ref):
    dh, dw = ref.shape[2] - y.shape[2], ref.shape[3] - y.shape[3]
    if dh or dw:
        y = F.pad(y, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return y


def bn_train(x, p):
    """Batch statistics (biased variance) normalize; returns (y, mean,
    unbiased variance) with the last two for the running statistics."""
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
    y = ((x - mean.view(1, -1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1) + EPS)
         * p["scale"].view(1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1))
    cnt = x.shape[0] * x.shape[2] * x.shape[3]
    return y, mean.detach(), (var * (cnt / max(cnt - 1, 1))).detach()


def bn_eval(x, p, s):
    inv = 1.0 / torch.sqrt(s["var"] + EPS)
    return ((x - s["mean"].view(1, -1, 1, 1)) * (inv * p["scale"]).view(
        1, -1, 1, 1) + p["bias"].view(1, -1, 1, 1))


def _dconv(p, x, train, s=None, cast=None):
    """DoubleConv; train returns (y, [(mean, var) of bn1, bn2])."""
    if train:
        h, m1, v1 = bn_train(conv3(x, p["conv1"]["w"]), p["bn1"])
        h, m2, v2 = bn_train(conv3(torch.relu(h), p["conv2"]["w"]), p["bn2"])
        return torch.relu(h), (m1, v1, m2, v2)
    h = torch.relu(bn_eval(conv3(x, p["conv1"]["w"], cast=cast), p["bn1"],
                           s["bn1"]))
    h = bn_eval(conv3(h, p["conv2"]["w"], cast=cast), p["bn2"], s["bn2"])
    return torch.relu(h), None


DCONV_PATHS = (("inc",), ("down1",), ("down2",), ("down3",), ("down4",),
               ("up1", "conv"), ("up2", "conv"), ("up3", "conv"),
               ("up4", "conv"))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def unet(p, x, *, train, s=None, ckpt=False, cast=None):
    """(L, H, stats): stats maps each DoubleConv path to its batch
    (mean, var) pairs in train mode. ``cast`` rounds every conv's
    operands (eval only: the fp8 control)."""
    stats = {}

    def block(path, fn, *args):
        if train and ckpt:
            y, st = checkpoint(fn, *args, use_reentrant=False)
        else:
            y, st = fn(*args)
        stats[path] = st
        return y

    def dc(path):
        return lambda inp: _dconv(_get(p, path), inp, train,
                                  None if s is None else _get(s, path),
                                  cast)

    x1 = block(("inc",), dc(("inc",)), x)
    feats = [x1]
    for i in range(1, 5):
        feats.append(block((f"down{i}",), dc((f"down{i}",)),
                           F.max_pool2d(feats[-1], 2)))
    y = feats[-1]
    for i in range(1, 5):
        path = (f"up{i}", "conv")
        up = p[f"up{i}"]["up"]

        def upblock(yy, skip, _up=up, _dc=dc(path)):
            u = pad_to(convT(yy, _up["w"], _up["b"], cast), skip)
            return _dc(torch.cat([skip, u], dim=1))

        y = block(path, upblock, y, feats[4 - i])
    return x1, y, stats


def twin_logits(L_t, H_t, L_d, H_d):
    vt = (L_t * H_t).sum(1)
    vd = (L_d * H_d).sum(1)
    return vt, vd


def jsd_loss(L_t, L_d, vt, vd):
    s = torch.softmax(torch.stack([vt, vd], dim=-1), dim=-1)
    st, sd = s[..., 0], s[..., 1]
    ct, cd = L_t.sum(1), L_d.sum(1)

    def jsd(l, a, b):
        return -F.softplus(-l * a).mean() - F.softplus(l * b).mean()

    return -(jsd(ct, st, sd) + jsd(cd, sd, st)) / 2.0


def nchw(x_nhwc):
    return x_nhwc.permute(0, 3, 1, 2).contiguous()


def train_steps(params, state, batches, lr: float):
    """Run the reference train step on each NHWC batch in order, from
    ``params``/``state`` (the port's tree, float32; copied, not changed).
    Returns {"loss": [per step], "grad": {leaf: norm of step 1's
    gradient}, "param": {leaf: params after the last step}, "state":
    {leaf: BN state after the last step}}."""
    from benchmark.inputs.onet_weights import leaves

    with exact_fp32():
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in leaves(params)}
        st = {k: v.detach().clone() for k, v in leaves(state)}
        tree_p = _unflatten(p)
        tree_s = _unflatten(st)
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        out = {"loss": [], "grad": None}
        dtype = next(iter(p.values())).dtype
        for t, xb in enumerate(batches, start=1):
            x = nchw(xb.to(dtype))
            xd = torch.clamp(1.0 - x, 0.0, 1.0)
            top, stop = tree_p["top"], tree_s["top"]
            lt, ht, stt = unet(top, x, train=True, ckpt=True)
            ld, hd, std_ = unet(top, xd, train=True, ckpt=True)
            vt, vd = twin_logits(lt, ht, ld, hd)
            loss = jsd_loss(lt, ld, vt, vd)
            names = list(p)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            for stats in (stt, std_):         # top first, then down
                _ema_branch(stop, stats)
            del lt, ht, ld, hd, vt, vd
            out["loss"].append(float(loss.detach()))
            if out["grad"] is None:
                out["grad"] = {k: float(g.norm()) for k, g in
                               zip(names, grads)}
            with torch.no_grad():
                for k, g in zip(names, grads):
                    m[k].mul_(B1).add_((1 - B1) * g)
                    v2[k].mul_(B2).add_((1 - B2) * g * g)
                    mh = m[k] / (1 - B1 ** t)
                    vh = v2[k] / (1 - B2 ** t)
                    p[k].sub_(lr * mh / (torch.sqrt(vh) + ADAM_EPS))
        out["param"] = {k: v.detach() for k, v in p.items()}
        out["state"] = dict(_flatten(tree_s))
        return out


def _ema_branch(state_top, stats):
    """r <- (1 - m) r + m s for one branch's batch statistics."""
    for path, (m1, v1, m2, v2) in stats.items():
        st = _get(state_top, path)
        for key, mean, var in (("bn1", m1, v1), ("bn2", m2, v2)):
            r = st[key]
            r["mean"] = (1 - MOMENTUM) * r["mean"] + MOMENTUM * mean
            r["var"] = (1 - MOMENTUM) * r["var"] + MOMENTUM * var


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return tree


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    return [(".".join(prefix), tree)]


@torch.no_grad()
def eval_logits(params, state, x_nhwc, block: int = 4, cast=None):
    """(vt, vd) [N, H, W] of the eval-mode twin (running statistics, no
    folding), in blocks of ``block`` frames; ``cast`` rounds every conv's
    operands (``fp8_e4m3``: the control of a bf16 configuration)."""
    top, stop = params["top"], state["top"]
    vts, vds = [], []
    with exact_fp32():
        for lo in range(0, x_nhwc.shape[0], block):
            x = nchw(x_nhwc[lo:lo + block].float())
            xd = torch.clamp(1.0 - x, 0.0, 1.0)
            lt, ht, _ = unet(top, x, train=False, s=stop, cast=cast)
            ld, hd, _ = unet(top, xd, train=False, s=stop, cast=cast)
            vt, vd = twin_logits(lt, ht, ld, hd)
            vts.append(vt)
            vds.append(vd)
    return torch.cat(vts), torch.cat(vds)


def label_gap(vt, vd, labels):
    """How far each served label's logit lies below the reference's best,
    in units of the std of the reference's margin vt - vd over the
    sample. Returns {"label_gap": the widest gap, "mean_gap": the mean
    gap over every pixel, "flip_share": the share of pixels whose label
    is not the reference's best}. Label 0 is the top branch, 1 the down
    branch; a tie goes to 0, as argmax does."""
    margin = vt - vd
    lab = labels.to(margin.device).long()
    gap = torch.where(lab == 0, torch.clamp(-margin, min=0),
                      torch.clamp(margin, min=0))
    best = (margin < 0).long()
    scale = max(float(margin.float().std()), 1e-30)
    return {"label_gap": float(gap.max()) / scale,
            "mean_gap": float(gap.double().mean()) / scale,
            "flip_share": float((lab != best).float().mean())}
