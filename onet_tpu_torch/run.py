"""Unified CLI for the workloads (``onet_tpu/run.py``).

The reference's entry points are per-script ``python Train_Onet_on_*.py``
with hard-coded paths; here one CLI drives every workload from the YAML
config (same schema), with the JAX package's subcommands, flags and
defaults:

  python -m onet_tpu_torch.run simclutter [--config path.yml] [--epochs N]
  python -m onet_tpu_torch.run zy3        [--train-file x.pt --test-file y.pt]
  python -m onet_tpu_torch.run nau        [--model ckpt.npz --test-file z.pt]
  python -m onet_tpu_torch.run gen-data   [--out rayleigh.npz]
  python -m onet_tpu_torch.run prepare-zy3 --src DIR [--masks DIR] --out x.pt
  python -m onet_tpu_torch.run zy3 --choose-preprocess DIR \\
      --choose-masks DIR --model ckpt.npz [--classified]
  python -m onet_tpu_torch.run reproduce  [--scale smoke] [--out DIR]

(installed as ``onet-tpu-torch``). Every subcommand takes ``--device``:
the default runs on the card and raises without one; ``--device cpu``
runs the kernels' plain versions on the CPU. Each subcommand calls the
port's library for its workload in this one process.

Where the JAX package differs: ``export-artifact`` has no
``--platforms`` (the artifact is exported on the device that serves it,
``serve/artifact.py``); ``bench`` and the multi-device flags ``--dp``,
``--pp`` and ``--sp`` exit with a message naming the work that brings
them; figures are drawn where matplotlib is installed
(``report.can_draw``). Workloads fall back to device-synthesized data when
the reference .pt files are not on disk, so every command runs out of the
box.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from onet_tpu_torch.core.config import DEFAULT_CONFIG

PARALLEL_LATER = ("the port's command line runs in one process; starting "
                  "the ranks for --dp, --pp and --sp is the next slice of "
                  "the port (ROADMAP.md, Queue A item 7). Until then drive "
                  "a mesh from a script: parallel/multihost.py::initialize "
                  "under torchrun, one process a card")
BENCH_LATER = ("bench: the port's benchmark comes in its own PR after "
               "ROADMAP.md's Queue A (a bench file beside bench.py, CUDA-"
               "event timing); bench.py itself is the JAX package's")


def _parse_sp(spec: str) -> tuple:
    """Parse --sp 'R' or 'RxC' into (rows, cols), SystemExit on malformed
    input ('two', '2x2x2', '0x3', ...)."""
    import re
    m = re.fullmatch(r"(\d+)(?:x(\d+)?)?", spec.strip())
    if not m:
        raise SystemExit(f"--sp {spec!r}: expected ROWS or ROWSxCOLS "
                         "(positive integers, e.g. --sp 2 or --sp 2x2)")
    rows, cols = int(m.group(1)), int(m.group(2) or 1)
    if rows < 1 or cols < 1:
        raise SystemExit(f"--sp {spec!r}: rows/cols must be >= 1")
    return rows, cols


def _add_common(p):
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-sz", type=int, default=None)
    p.add_argument("--out-root", type=str, default=None)
    p.add_argument("--base-channels", type=int, default=64)
    p.add_argument("--in-channels", type=int, default=1)
    p.add_argument("--input-sz", type=int, default=224)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card), "
                        "cuda:N, or cpu (the kernels' plain versions)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="onet_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("simclutter", "zy3", "nau", "gen-data", "bench", "sweep",
                 "serve", "summary", "import-torch", "export-torch",
                 "export-artifact", "infoseg", "iic", "prepare-zy3",
                 "verify-data", "reproduce"):
        p = sub.add_parser(name)
        _add_common(p)
        if name in ("simclutter", "zy3"):
            p.add_argument("--arch",
                           choices=["vanilla", "swin", "convnext",
                                    "transunet"],
                           default="vanilla",
                           help="backbone family (models/arch.py): the "
                                "vanilla conv U-Net, or the Swin-Unet, "
                                "ConvNeXt-UNet or TransUNet ablation")
            p.add_argument("--swin-window", type=int, default=7,
                           help="Swin attention window (7 fits 224^2 "
                                "inputs, 8 fits 512^2)")
            p.add_argument("--swin-embed", type=int, default=96,
                           help="Swin embed width (96 = published Swin-T)")
            p.add_argument("--convnext-embed", type=int, default=96,
                           help="ConvNeXt stage-0 width (96 = published "
                                "ConvNeXt-T)")
            p.add_argument("--transunet-embed", type=int, default=768,
                           help="TransUNet ViT hidden width (768 = "
                                "published ViT-B; must be divisible "
                                "by 48)")
            p.add_argument("--transunet-depth", type=int, default=12,
                           help="TransUNet ViT depth (12 = published "
                                "ViT-B)")
            p.add_argument("--loss", choices=["jsd", "rsn"], default="jsd",
                           help="training objective: the reference JSD "
                                "(complement-branch negatives) or the RSN "
                                "random-sampling-negative ablation "
                                "(in-batch negatives)")
        if name == "zy3":
            p.add_argument("--train-file", default=None)
            p.add_argument("--test-file", default=None)
            p.add_argument("--cloud-addition", action="store_true",
                           help="train on cloud-addition composites "
                                "(terrain + synthetic clouds; reference "
                                "CloudDataset_CloudAddition)")
            p.add_argument("--n-train", type=int, default=64)
            p.add_argument("--n-test", type=int, default=16)
            p.add_argument("--restart-from", default=None, metavar="CKPT",
                           help="continue training from this checkpoint "
                                "(`restart: True` + `model_file:` in the "
                                "YAML does the same)")
            p.add_argument("--dp", type=int, default=0,
                           help="data-parallel training over N devices "
                                "(the next slice of the port). 0 = single "
                                "device")
            p.add_argument("--choose-preprocess", default=None,
                           metavar="SRC_DIR",
                           help="run the preprocessing-SELECTION workload "
                                "instead of training: score every "
                                "admissible pre-option per raw scene with "
                                "a trained model (--model) and keep the "
                                "best-mIoU variant (the reference's "
                                "oracle protocol); writes the best-dict "
                                ".pt + xlsx report and evaluates the "
                                "divided testset on it")
            p.add_argument("--choose-masks", default=None,
                           metavar="MASK_DIR",
                           help="ground-truth mask directory paired (by "
                                "sorted order) with --choose-preprocess "
                                "scenes")
            p.add_argument("--classified", action="store_true",
                           help="with --choose-preprocess: fixed per-"
                                "cloud-class assignment instead of the "
                                "oracle search")
            p.add_argument("--model", default=None,
                           help="checkpoint for --choose-preprocess "
                                "(.npz or reference .pytorch; falls back "
                                "to the YAML model_file)")
            p.add_argument("--out-dict", default=None,
                           help="output path for the best-preprocess "
                                "dict (.pt reference schema or .npz; "
                                "default <out_root>/zy3_test_best_"
                                "preprocess.pt)")
        if name == "prepare-zy3":
            p.add_argument("--src", required=True, metavar="DIR",
                           help="directory of raw RGB scenes (jpg/png)")
            p.add_argument("--masks", default=None, metavar="DIR",
                           help="optional mask PNG directory paired by "
                                "sorted order (>0.5 binarized)")
            p.add_argument("--pre-option", default="raw_rgb",
                           choices=["raw_rgb", "histeq_rgb",
                                    "contrast_enhance", "haze_enhance",
                                    "haze_remove", "histeq_haze_enhance",
                                    "histeq_haze_remove",
                                    "contrast_enhance_haze_enhance",
                                    "contrast_enhance_haze_remove"],
                           help="preprocessing applied to every thumbnail "
                                "(the 9 options of make_thrumnail_image)")
            p.add_argument("--out", required=True,
                           help=".pt (reference dict-of-dicts schema) or "
                                ".npz output")
            p.add_argument("--resize-to", type=int, default=300)
            p.add_argument("--crop", type=int, default=224)
            p.add_argument("--id-prefix", default="",
                           help="prefix for dict keys (the reference "
                                "uses 'zy3_test_')")
        if name == "reproduce":
            p.add_argument("--scale", choices=["micro", "smoke", "paper"],
                           default="smoke",
                           help="micro: CPU-feasible chain check (base-8 "
                                "model, 32px); smoke: minutes-level "
                                "end-to-end chain drive; paper: the "
                                "published protocol (301/60/11 epochs, "
                                "150 frames/level)")
            p.add_argument("--out", default=None,
                           help="artifact root (default "
                                "runs/reproduce_<scale>)")
        if name == "verify-data":
            p.add_argument("file", help="reference-schema .pt to validate "
                                        "(simclutter/zy3/nau)")
            p.add_argument("--workload", default="auto",
                           choices=["auto", "simclutter", "zy3", "nau"],
                           help="schema to check against (default: sniff "
                                "from the file's key structure)")
            p.add_argument("--no-eval", action="store_true",
                           help="skip the one-batch forward probe (schema "
                                "checks only)")
        if name == "nau":
            p.add_argument("--model", default=None)
            p.add_argument("--test-file", default=None)
            p.add_argument("--cfar", type=float, default=None,
                           metavar="KVAL",
                           help="ALSO report the CA-CFAR baseline at this "
                                "threshold factor (kval 2.0 ~ far 0.03)")
            p.add_argument("--infoseg", default=None, metavar="CKPT",
                           help="ALSO report the InfoSeg baseline from "
                                "this checkpoint (train one with `run "
                                "infoseg`)")
            p.add_argument("--iic", default=None, metavar="CKPT",
                           help="ALSO report the IIC baseline from this "
                                "checkpoint (train one with `run iic`)")
            p.add_argument("--compare-fig", action="store_true",
                           help="save the method-comparison grid (input/"
                                "gt/baselines/Onet columns with P_fa "
                                "titles; needs matplotlib)")
            p.add_argument("--model2", default=None, metavar="CKPT",
                           help="ALSO report the two-stage 'Onet2' "
                                "ensemble: stage-1 = --model, stage-2 = "
                                "this checkpoint fed the normalized fg "
                                "projection")
            p.add_argument("--model-tw", default=None, metavar="CKPT",
                           help="ALSO report a twin-weights (no-share) "
                                "'Onet_TW' checkpoint on the same frames")
        if name == "gen-data":
            p.add_argument("--out", default="rayleigh_dataset.npz",
                           help="output file: .npz/.ts (native) or .pt "
                                "(reference torch schema, data/export.py)")
            p.add_argument("--bg", choices=["rayleigh", "k"],
                           default="rayleigh",
                           help="clutter family (reference bg_type)")
            p.add_argument("--workload",
                           choices=["simclutter", "zy3", "nau"],
                           default="simclutter",
                           help="which dataset family to generate: "
                                "simclutter clutter frames, ZY-3 cloud "
                                "scenes, or NAU rain frames (synthetic "
                                "stand-ins for the latter two)")
            p.add_argument("--frames-per-level", type=int, default=150,
                           help="simclutter: frames per PSNR level "
                                "(reference: 150)")
            p.add_argument("--levels", default="0-10",
                           help="simclutter: PSNR range low-high "
                                "(reference prepare_data: 0-10)")
            p.add_argument("--crop", type=int, default=224,
                           help="simclutter: center-crop size")
            p.add_argument("--n", type=int, default=16,
                           help="zy3/nau: number of scenes")
        if name == "simclutter":
            p.add_argument("--frames-per-level", type=int, default=150)
            p.add_argument("--data-file", default=None,
                           help="reference-format .pt/.npz dataset "
                                "(device generation when absent)")
            p.add_argument("--int8-train", default=None,
                           choices=["fwd", "fwd+dx"],
                           help="opt-in int8 training arithmetic "
                                "(models/qtrain.py)")
            p.add_argument("--bg", choices=["rayleigh", "k"],
                           default="rayleigh",
                           help="clutter family (reference bg_type: "
                                "rayleigh.rvs or correlated K field)")
            p.add_argument("--dp", type=int, default=0,
                           help="data-parallel over N devices (the next "
                                "slice of the port). 0 = single device")
            p.add_argument("--pp", type=int, default=0, metavar="M",
                           help="pipeline-parallel training with M "
                                "microbatches (the next slice of the "
                                "port). 0 = off")
            p.add_argument("--sp", default=None, metavar="R[xC]",
                           help="spatially-partitioned training over R "
                                "(x C) devices (the next slice of the "
                                "port)")
            p.add_argument("--resume", action="store_true",
                           help="auto-resume from the newest checkpoint "
                                "under out_root (params, BN state, Adam "
                                "moments, epoch; `restart: True` in the "
                                "YAML does the same)")
            p.add_argument("--no-weight-share", dest="weight_share",
                           action="store_false", default=True,
                           help="train the twin-weights variant (separate "
                                "U-Nets per branch; its checkpoints feed "
                                "nau --model-tw)")
        if name == "sweep":
            p.add_argument("--model", default=None,
                           help=".npz checkpoint (fresh init if absent)")
            p.add_argument("--model-dir", default=None,
                           help="verify EVERY checkpoint (.npz and "
                                "reference .pt/.pytorch) in a directory "
                                "across the PSNR levels; mixed backbone "
                                "families supported via checkpoint arch "
                                "metadata")
            p.add_argument("--frames-per-level", type=int, default=150)
            p.add_argument("--far-budgets", default=None,
                           help="comma list (e.g. 0.01,0.05): ALSO report "
                                "threshold-detector dr at these FAR budgets")
        if name == "serve":
            p.add_argument("--model", required=True,
                           help=".npz checkpoint (or reference .pt, or an "
                                "artifact from export-artifact)")
            p.add_argument("--input", default=None,
                           help=".npz with 'imgs' NHWC in [0,1] "
                                "(synthetic frames when absent)")
            p.add_argument("--out", default="masks.npz")
            p.add_argument("--int8", action="store_true",
                           help="int8 PTQ serving (models/quant.py); "
                                "calibrates on the first batch")
            p.add_argument("--serve-batch", type=int, default=32)
            p.add_argument("--tile", type=int, default=0,
                           help="tile arbitrarily large scenes into "
                                "NxN context windows (serve/tiles.py)")
            p.add_argument("--halo", type=int, default=32)
            p.add_argument("--far-budget", type=float, default=None,
                           help="serve THRESHOLDED detections at this "
                                "false-alarm budget instead of argmax "
                                "masks (threshold calibrated on the input "
                                "clutter and stored in "
                                "<model>.detector.json)")
            p.add_argument("--fg", choices=["down", "top"], default="down",
                           help="which branch carries the foreground "
                                "(assign_fg_mark convention)")
            p.add_argument("--dp", type=int, default=0,
                           help="data-parallel serving over N devices "
                                "(the next slice of the port). 0 = single "
                                "device")
            p.add_argument("--http", type=int, default=None, metavar="PORT",
                           help="stay resident and serve the warm step "
                                "over HTTP (npy in/out; 0 = ephemeral "
                                "port; serve/http.py)")
            p.add_argument("--http-requests", type=int, default=0,
                           help="with --http: answer N requests then exit "
                                "(0 = run forever)")
        if name == "import-torch":
            p.add_argument("--pt", required=True,
                           help="reference .pt/.pth/.pytorch checkpoint "
                                "({'net': state_dict, 'epoch': N} or a "
                                "bare state_dict)")
            p.add_argument("--out", default=None,
                           help="output .npz (default: <pt>.npz). Note "
                                "serve/sweep/nau also accept the .pt "
                                "file directly")
        if name in ("infoseg", "iic"):
            p.add_argument("--frames-per-level", type=int, default=150)
            p.add_argument("--low-snr", type=int, default=0)
            p.add_argument("--high-snr", type=int, default=2)
        if name == "export-artifact":
            p.add_argument("--model", required=True,
                           help=".npz (or reference .pt) checkpoint; "
                                "width/channels/twin-ness inferred")
            p.add_argument("--out", default=None,
                           help="output artifact (default: <model>.onetx)")
            p.add_argument("--serve-batch", type=int, default=0,
                           help="pin the artifact's batch size (0 = "
                                "symbolic: one artifact serves any batch)")
            p.add_argument("--int8", action="store_true",
                           help="bake the int8 PTQ graph instead of bf16 "
                                "(models/quant.py; calibrates on --calib "
                                "or synthetic clutter frames)")
            p.add_argument("--calib", default=None,
                           help=".npz with 'imgs' NHWC in [0,1] for int8 "
                                "calibration (first 8 frames used)")
        if name == "export-torch":
            p.add_argument("--model", required=True,
                           help="onet-tpu .npz checkpoint (model width/"
                                "channels/twin-ness inferred from it)")
            p.add_argument("--out", default=None,
                           help="output .pytorch (default: "
                                "<model>.pytorch); loads in the "
                                "reference via torch.load(f)['net']")
    return parser


def _refuse_parallel(args) -> None:
    """--dp / --pp / --sp other than off: exit, never one device quietly."""
    if getattr(args, "sp", None):
        _parse_sp(args.sp)
    for flag in ("dp", "pp", "sp"):
        if getattr(args, flag, None):
            raise SystemExit(f"--{flag} {getattr(args, flag)}: "
                             + PARALLEL_LATER)


def _round(metrics: dict) -> dict:
    return {k: round(float(v), 4) for k, v in metrics.items()}


def _groups(ids):
    """The cloud-class division stand-in: round-robin groups."""
    from onet_tpu_torch.train.zy3 import GROUP_NAMES
    return {g: [ids[i] for i in range(gi, len(ids), 3)]
            for gi, g in enumerate(GROUP_NAMES)}


def _division(cfg_yaml, ids):
    """The reference's division table when configured, else the
    round-robin stand-in groups."""
    division_file = getattr(cfg_yaml, "division_file", None)
    if division_file and os.path.exists(division_file):
        from onet_tpu_torch.preprocess.curation import load_division_table
        return load_division_table(division_file)
    return _groups(ids)


def _run_choose_preprocess(args, cfg_yaml, policy, dev):
    """The preprocessing-selection workload (`run zy3 --choose-preprocess`):
    the reference's test_pre_processing_on_zy3_testset __main__
    (:506-562) — load a trained model, score every admissible pre-option
    per raw scene (oracle best-mIoU, or the fixed per-class assignment
    with --classified), save the best-dict .pt + xlsx report, then
    evaluate the divided testset on the selected thumbnails."""
    import torch

    from onet_tpu_torch.core.checkpoint import datehour_mark, load_arch_auto
    from onet_tpu_torch.data.arrays import ArrayDataset
    from onet_tpu_torch.preprocess.onramp import (choose_preprocess,
                                                  classified_choose,
                                                  id_from_filename,
                                                  list_scene_files,
                                                  save_zy3_dict,
                                                  write_preprocess_report)
    from onet_tpu_torch.train.zy3 import save_zy3_test_results

    if not args.choose_masks:
        raise SystemExit("--choose-preprocess needs --choose-masks DIR: "
                         "the selection scores each option against ground "
                         "truth (oracle evaluation protocol)")
    model = args.model or getattr(cfg_yaml, "model_file", None)
    if not model or not os.path.exists(model):
        raise SystemExit("--choose-preprocess needs --model CKPT (.npz or "
                         "reference .pytorch; or model_file in the YAML)")
    src_files = list_scene_files(args.choose_preprocess)
    mask_files = list_scene_files(args.choose_masks)
    if not src_files:
        raise SystemExit(f"{args.choose_preprocess}: no scenes found")
    if len(src_files) != len(mask_files):
        raise SystemExit(f"{len(src_files)} scenes but {len(mask_files)} "
                         "masks (paired by sorted filename order)")
    arch, params, bn_state, _ = load_arch_auto(model, dev)
    fwd = None if arch.vanilla else arch.forward
    out_root = args.out_root or cfg_yaml.out_root
    os.makedirs(out_root, exist_ok=True)
    ids = ["zy3_test_" + id_from_filename(f) for f in src_files]
    groups = _division(cfg_yaml, ids)

    if args.classified:
        best, rows = classified_choose(
            params, bn_state, src_files, mask_files, groups,
            policy=policy, forward=fwd, device=dev)
        tag = "classified"
    else:
        best, rows = choose_preprocess(
            params, bn_state, src_files, mask_files, groups=groups,
            policy=policy, forward=fwd, progress=True, device=dev)
        tag = "best"
    mean_acc = float(np.mean([r["acc"] for r in rows]))
    mean_miou = float(np.mean([r["miou"] for r in rows]))
    for r in rows:
        print("%s,\t input,%10s,acc,%.4f,miou,%.4f, classified type, %s"
              % (r["img_id"], r["opt"], r["acc"], r["miou"],
                 r["classified_type"]))
    print("acc %.4f, miou %.4f after pre-processing" % (mean_acc, mean_miou))

    out_dict = args.out_dict or os.path.join(
        out_root, f"zy3_test_{tag}_preprocess.pt")
    save_zy3_dict(out_dict, best)
    xlsx = write_preprocess_report(
        os.path.join(out_root,
                     f"zy3_testset_{tag}_preprocess_{datehour_mark()}.xlsx"),
        rows)
    print(f"[choose-preprocess] dict: {out_dict}")
    print(f"[choose-preprocess] report: {xlsx}")

    # the reference __main__ tail (:553-562): evaluate the divided testset
    # on the selected thumbnails
    keys = list(best)
    ds = ArrayDataset({
        "imgs": torch.stack([torch.as_tensor(best[k]["img"]) for k in keys]),
        "labels": torch.stack([torch.as_tensor(best[k]["mask"])
                               for k in keys])})
    excel_path = os.path.join(
        out_root, f"zy3_results_{tag}_preprocess_{datehour_mark()}.xlsx")
    path, summary = save_zy3_test_results(
        excel_path, params, bn_state, ds, keys, groups,
        batch_sz=min(5, len(keys)), policy=policy, draw=False,
        model_name=f"onet_{tag}_preprocess", forward=fwd)
    print(f"[choose-preprocess] divided-testset report: {path}")
    print(summary.to_string(index=False))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _save_arrays(out: str, arrays: dict) -> str:
    """.ts: the tile store; anything else: an .npz of host arrays."""
    if out.endswith(".ts"):
        from onet_tpu_torch.data.tilestore import save_store
        return save_store(out, arrays)
    np.savez(out, **{k: _host(v) for k, v in arrays.items()})
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)

    from onet_tpu_torch.core.cache import enable_compilation_cache
    enable_compilation_cache()

    if args.cmd == "bench":
        raise SystemExit(BENCH_LATER)
    _refuse_parallel(args)

    import torch

    from onet_tpu_torch.core.config import generate_config
    from onet_tpu_torch.core.device import resolve_device
    from onet_tpu_torch.core.policy import BF16_COMPUTE, DEFAULT
    from onet_tpu_torch.core.prng import make_generator
    from onet_tpu_torch.report import can_draw

    dev = resolve_device(args.device)
    policy = BF16_COMPUTE if args.bf16 else DEFAULT

    if args.cmd == "reproduce":
        # one-command full-protocol reproduction (runs/reproduce_all.py):
        # chains the reference's entire published recipe and writes
        # REPRODUCE.md with every number beside its reference anchor
        from onet_tpu_torch.runs.reproduce_all import run as reproduce_run
        out = args.out or os.path.join("runs", f"reproduce_{args.scale}")
        reproduce_run(args.scale, out, device=dev)
        return

    if args.cmd == "summary":
        # model summary: static FLOP/param table + live traced per-layer
        # shapes (the reference's count_parameters / get_model_summary
        # surface, utils_20231218.py:29-42,692-811)
        from onet_tpu_torch.models.onet import onet_init
        from onet_tpu_torch.utils.summary import (
            model_summary, runtime_layer_summary, count_parameters)
        params, state = onet_init(torch.Generator().manual_seed(0),
                                  args.in_channels, base=args.base_channels,
                                  device=dev)
        print(f"params: {count_parameters(params):.2f} M")
        print(f"{'stage':<16}{'out_shape':<22}{'params':>10}{'GFLOP':>10}")
        for r in model_summary(params, input_hw=(args.input_sz,) * 2,
                               in_channels=args.in_channels):
            print(f"{r['name']:<16}{str(r['out_shape']):<22}"
                  f"{r['params']:>10}{r['fwd_flops'] / 1e9:>10.2f}")
        x = torch.zeros((1, args.input_sz, args.input_sz, args.in_channels),
                        dtype=torch.float32, device=dev)
        rows = runtime_layer_summary(params, state, x)
        print(f"\ntraced graph: {len(rows)} layer ops "
              f"(first {rows[0]['op']} -> {rows[0]['out_shape']}, "
              f"last {rows[-1]['op']} -> {rows[-1]['out_shape']})")
        return

    if args.cmd == "import-torch":
        # Bring reference-trained torch checkpoints across (the
        # reference's torch.save schema,
        # Train_Onet_on_simclutter_20250407.py:265-266).
        from onet_tpu_torch.core.bridge import import_torch_checkpoint
        from onet_tpu_torch.core.checkpoint import save_checkpoint
        from onet_tpu_torch.utils.summary import count_parameters
        params, bn, epoch = import_torch_checkpoint(args.pt, device=dev)
        out = args.out or (os.path.splitext(args.pt)[0] + ".npz")
        save_checkpoint(out, params, bn, epoch)
        share = "shared" if "down" not in params else "twin"
        print(f"[import-torch] {args.pt} -> {out}: "
              f"{count_parameters(params):.2f} M params ({share}), "
              f"epoch {epoch}")
        return

    if args.cmd == "export-torch":
        # The reverse bridge: models trained here run in the reference's
        # own torch scripts (onet.load_state_dict(torch.load(f)['net']),
        # Train_Onet_on_simclutter_20250407.py:493).
        from onet_tpu_torch.core.bridge import (export_torch_checkpoint,
                                                load_onet_npz)
        params, bn, epoch = load_onet_npz(args.model, dev)
        kh, kw, cin, base = params["top"]["inc"]["conv1"]["w"].shape
        twin = "down" in params
        out = args.out or (os.path.splitext(args.model)[0] + ".pytorch")
        export_torch_checkpoint(out, params, bn, epoch)
        print(f"[export-torch] {args.model} -> {out}: base {base}, "
              f"in_channels {cin}, {'twin' if twin else 'shared'}, "
              f"epoch {epoch}")
        return

    if args.cmd == "export-artifact":
        # Deployment bundle: the BN-folded serving graph exported with
        # torch.export, weights baked in (serve/artifact.py), on the
        # device that will serve it. Loads with zero model code;
        # `serve --model x.onetx` consumes it.
        from onet_tpu_torch.core.checkpoint import (load_checkpoint,
                                                    load_onet_auto,
                                                    read_checkpoint_meta)
        from onet_tpu_torch.models.arch import arch_from_meta
        from onet_tpu_torch.serve.artifact import (export_fn_artifact,
                                                   export_serving_artifact)
        ck_meta = read_checkpoint_meta(args.model)
        arch = arch_from_meta(ck_meta)
        if not arch.vanilla:
            # stateless backbone families export their plain forward
            # (no BN to fold; the quant path is conv-U-Net-specific)
            if args.int8:
                raise SystemExit(
                    f"--int8 quantizes the folded conv U-Net; the "
                    f"checkpoint is --arch {arch.name} (bf16/fp32 "
                    "artifacts work)")
            from onet_tpu_torch.models.onet import predict_label
            from onet_tpu_torch.utils.summary import count_parameters
            in_ch = ck_meta.get("in_channels", args.in_channels)
            params, state = arch.init(
                torch.Generator().manual_seed(0), in_ch,
                weight_share=ck_meta.get("weight_share", True), device=dev)
            params, state, _ = load_checkpoint(args.model, params, state)

            def fn(x):
                with policy.precision():
                    out, _ = arch.forward(params, state, x, train=False,
                                          policy=policy)
                return (out.S.to(torch.float32),
                        predict_label(out.S).to(torch.int32))

            out = args.out or (os.path.splitext(args.model)[0] + ".onetx")
            meta = export_fn_artifact(
                fn, out, input_hw=(args.input_sz, args.input_sz),
                in_channels=in_ch, batch=args.serve_batch or None,
                extra_meta={"model": os.path.basename(args.model),
                            "arch": arch.name,
                            "arithmetic": str(policy.compute_dtype)
                            .removeprefix("torch."),
                            "params_m": round(float(
                                count_parameters(params)), 4)},
                device=dev)
            print(f"[export-artifact] {args.model} -> {out}: "
                  f"{os.path.getsize(out) / 1e6:.1f} MB, "
                  f"arch {arch.name}, {meta['arithmetic']}, "
                  f"input [{meta['batch']}, {args.input_sz}, "
                  f"{args.input_sz}, {in_ch}]")
            return
        params, bn, _ = load_onet_auto(args.model, dev)
        out = args.out or (os.path.splitext(args.model)[0] + ".onetx")
        cin = params["top"]["inc"]["conv1"]["w"].shape[2]
        calib = None
        if args.int8:
            if args.calib:
                calib = np.load(args.calib)["imgs"].astype(np.float32)[:8]
            else:
                if (args.input_sz, cin) != (224, 1):
                    raise SystemExit(
                        "--int8 without --calib synthesizes 224^2 "
                        "grayscale clutter frames; pass --calib for "
                        f"{args.input_sz}^2 x{cin} inputs")
                from onet_tpu_torch.train.sweeps import per_snr_datasets
                data = per_snr_datasets(7, frames_per_level=8, levels=(5,),
                                        device=dev)
                calib = next(iter(data.values()))["imgs"]
                print("[export-artifact] int8 calibration on 8 synthetic "
                      "clutter frames (pass --calib for your data)")
        meta = export_serving_artifact(
            params, bn, out, input_hw=(args.input_sz, args.input_sz),
            in_channels=cin, batch=args.serve_batch or None, policy=policy,
            int8_calib=calib,
            extra_meta={"model": os.path.basename(args.model)}, device=dev)
        print(f"[export-artifact] {args.model} -> {out}: "
              f"{os.path.getsize(out) / 1e6:.1f} MB, {meta['arithmetic']}, "
              f"input [{meta['batch']}, {args.input_sz}, {args.input_sz}, "
              f"{cin}], device {meta['device']}")
        return

    if args.cmd == "verify-data":
        # real-data conformance kit: schema contract + stats + one eval
        # batch, so a real ZY-3/NAU/simclutter .pt drop-in is a 1-command
        # acceptance test (data/verify.py)
        from onet_tpu_torch.data.verify import format_report, verify_dataset
        report = verify_dataset(args.file, args.workload,
                                eval_batch=not args.no_eval, policy=policy,
                                device=dev)
        print(format_report(report))
        if not report["ok"]:
            raise SystemExit(1)
        return

    if args.cmd == "prepare-zy3":
        # raw-imagery on-ramp: jpg/png directory -> Resize(300)/
        # CenterCrop(224) thumbnails (+ binarized masks) in the
        # reference's dict .pt schema (make_thrumnail_image/
        # make_thumnail_mask, test_pre_processing_on_zy3_testset_20240607.py:
        # 99-212)
        from onet_tpu_torch.preprocess.onramp import (list_scene_files,
                                                      prepare_zy3_thumbnails,
                                                      save_zy3_dict)
        src = list_scene_files(args.src)
        if not src:
            raise SystemExit(f"--src {args.src}: no jpg/png scenes found")
        masks = None
        if args.masks:
            masks = list_scene_files(args.masks)
            if len(masks) != len(src):
                raise SystemExit(
                    f"{len(src)} scenes but {len(masks)} masks; the "
                    "pairing is by sorted filename order")
        prepared, ids = prepare_zy3_thumbnails(
            src, masks, pre_option=args.pre_option,
            resize_to=args.resize_to, crop=args.crop, device=dev)
        out = save_zy3_dict(args.out, prepared, id_prefix=args.id_prefix)
        print(f"[prepare-zy3] {len(ids)} scenes -> {out} "
              f"(pre_option={args.pre_option}, crop={args.crop}, "
              f"masks={'yes' if masks else 'no'})")
        return

    if args.cmd == "gen-data":
        # device generation -> file. A .pt output writes the reference's
        # own torch schema (data/export.py) so its unmodified dataloaders
        # consume generated data; .npz/.ts stay the native formats.
        if args.workload in ("zy3", "nau"):
            if args.workload == "zy3":
                from onet_tpu_torch.data.export import export_zy3_pt as export
                from onet_tpu_torch.data.zy3 import synthesize_zy3 as make
                what = "zy3 scenes"
            else:
                from onet_tpu_torch.data.export import export_nau_pt as export
                from onet_tpu_torch.data.nau import synthesize_nau_rain as make
                what = "nau frames"
            ds, ids = make(make_generator(1981, dev), n=args.n, device=dev)
            if args.out.endswith(".pt"):
                written = export(args.out, ds, ids)
            else:
                written = _save_arrays(args.out, {"imgs": ds["imgs"],
                                                  "labels": ds["labels"]})
            print(f"saved {written}: {args.n} {what} "
                  f"{tuple(ds['imgs'].shape[1:])}")
            return
        from onet_tpu_torch.sim.rayleigh import generate_rayleigh_dataset
        low, _, high = args.levels.partition("-")
        levels = tuple(range(int(low), int(high or low) + 1))
        d = generate_rayleigh_dataset(
            make_generator(1981, dev), bg=args.bg, levels=levels,
            frames_per_level=args.frames_per_level, crop=args.crop,
            device=dev)
        if args.out.endswith(".pt"):
            from onet_tpu_torch.data.export import export_simclutter_pt
            written = export_simclutter_pt(args.out, d, bg=args.bg)
        else:
            written = _save_arrays(args.out, d)
        print(f"saved {written}: imgs {tuple(d['imgs'].shape)}")
        return

    if args.cmd in ("infoseg", "iic"):
        # Train a baseline on simulated clutter: InfoSeg (the reference's
        # snapshot-absent InfoSeg_Simbg model, exp_nau_rain_20240513.py:33)
        # or IIC (the united config's fourth model family,
        # config_tip2022_20230411.py:2,46-100); evaluate either beside
        # Onet with `run nau --infoseg/--iic <ckpt>`
        if args.cmd == "infoseg":
            from onet_tpu_torch.train.infoseg import InfoSegConfig as Config
            from onet_tpu_torch.train.infoseg import train
        else:
            from onet_tpu_torch.train.iic import IICConfig as Config
            from onet_tpu_torch.train.iic import train
        cfg = Config(
            input_sz=args.input_sz, in_channels=args.in_channels,
            base_channels=args.base_channels, low_snr=args.low_snr,
            high_snr=args.high_snr, frames_per_level=args.frames_per_level)
        if args.epochs is not None:
            cfg.epoch_nums = args.epochs
        if args.batch_sz is not None:
            cfg.batch_sz = args.batch_sz
        if args.out_root is not None:
            cfg.out_root = args.out_root
        _, _, hist = train(cfg, policy=policy, device=dev)
        print(_round(hist["eval"][cfg.epoch_nums - 1]))
        return

    if args.cmd == "sweep":
        # per-PSNR verification (verify_onet_simclutter equivalent)
        from onet_tpu_torch.core.checkpoint import load_arch_auto
        from onet_tpu_torch.models.onet import onet_init
        from onet_tpu_torch.train.sweeps import per_snr_datasets, test_by_snr
        data = per_snr_datasets(7, frames_per_level=args.frames_per_level,
                                device=dev)
        if args.model_dir:
            from onet_tpu_torch.train.sweeps import verify_checkpoint_dir
            if args.far_budgets:
                print("[sweep] note: --far-budgets applies to single "
                      "--model sweeps, ignored with --model-dir")
            report = verify_checkpoint_dir(args.model_dir,
                                           datasets_by_psnr=data,
                                           policy=policy, device=dev)
            for fname, rec in report.items():
                a = rec["per_snr"]["ave"]
                print(f"{fname} (epoch {rec['epoch']}, arch {rec['arch']}): "
                      f"ave_acc:{a['acc']:.4f}, ave_miou:{a['miou']:.4f}, "
                      f"ave_dr:{a['dr']:.4f}, ave_far:{a['far']:.4f}")
            return
        fwd = None
        if args.model and os.path.exists(args.model):
            # the checkpoint rebuilds its own model: arch metadata for the
            # ablation families, shape inference for vanilla/torch files
            arch, params, bn, _ = load_arch_auto(args.model, dev)
            fwd = None if arch.vanilla else arch.forward
            print(f"[sweep] loaded {args.model} (arch {arch.name})")
        else:
            params, bn = onet_init(torch.Generator().manual_seed(1981), 1,
                                   base=args.base_channels, device=dev)
        report = test_by_snr(params, bn, data, policy=policy, forward=fwd)
        for psnr in sorted(k for k in report if k != "ave"):
            m = report[psnr]
            print("psnr:%02d, acc:%.4f, miou:%.4f, tiou:%.4f, dr:%.4f, "
                  "far:%.4f" % (psnr, m["acc"], m["miou"], m["tiou"],
                                m["dr"], m["far"]))
        a = report["ave"]
        print("PSNR0-10, ave_acc:%.4f, ave_miou:%.4f, ave_tiou:%.4f, "
              "ave_dr:%.4f, ave_far:%.4f"
              % (a["acc"], a["miou"], a["tiou"], a["dr"], a["far"]))
        if args.far_budgets:
            from onet_tpu_torch.train.sweeps import threshold_sweep_by_snr
            budgets = tuple(float(b) for b in args.far_budgets.split(","))
            trep = threshold_sweep_by_snr(params, bn, data,
                                          far_budgets=budgets, policy=policy,
                                          forward=fwd)
            for psnr in sorted(trep):
                parts = " ".join(
                    f"far<={b:g}: dr {v['dr']:.3f}"
                    for b, v in sorted(trep[psnr]["thresh"].items()))
                am = trep[psnr]["argmax"]
                print(f"psnr:{psnr:02d} threshold-detector | argmax dr "
                      f"{am['dr']:.3f} far {am['far']:.1E} | {parts}")
        return

    if args.cmd == "serve":
        _serve(args, policy, dev)
        return

    if args.cmd == "simclutter":
        cfg_yaml = generate_config(args.config, "Rayleigh", argv=[])
        from onet_tpu_torch.train.simclutter import SimclutterConfig, train
        datasets = None
        data_file = args.data_file or os.path.join(
            getattr(cfg_yaml, "dataset_root", ""),
            getattr(cfg_yaml, "data_file_name", "") or "")
        if data_file and os.path.exists(data_file):
            # reference rayleigh_2sigma.pt ingestion (make_simbg_dataloader,
            # dataloader/simbg4onet_20230209.py:99-152): per-frame normalize
            # + SNR-range filter + 90/10 split happen in simclutter_datasets
            from onet_tpu_torch.data.simclutter import (
                load_simclutter_pt, simclutter_datasets)
            src = load_simclutter_pt(data_file, device=dev)
            print(f"[simclutter] loaded {data_file}: "
                  f"{src['imgs'].shape[0]} frames")
            datasets = simclutter_datasets(
                make_generator(1981, dev),
                low_snr=getattr(cfg_yaml, "low_snr", 0),
                high_snr=getattr(cfg_yaml, "high_snr", 2),
                source=src, crop=min(cfg_yaml.input_sz,
                                     src["imgs"].shape[1]), device=dev)
        cfg = SimclutterConfig(
            model_name=cfg_yaml.model_name,
            epoch_nums=args.epochs or cfg_yaml.epoch_nums,
            batch_sz=args.batch_sz or cfg_yaml.batch_sz,
            input_sz=cfg_yaml.input_sz,
            low_snr=getattr(cfg_yaml, "low_snr", 0),
            high_snr=getattr(cfg_yaml, "high_snr", 2),
            frames_per_level=args.frames_per_level,
            bg=args.bg,
            base_lr=float(getattr(cfg_yaml, "base_lr", 5e-6)),
            out_root=args.out_root or cfg_yaml.out_root,
            base_channels=args.base_channels,
            quantized=args.int8_train,
            # --resume or the YAML's reference-schema `restart:` key
            resume=bool(args.resume
                        or getattr(cfg_yaml, "restart", False)),
            weight_share=args.weight_share,
            arch=args.arch,
            swin_window=args.swin_window,
            swin_embed=args.swin_embed,
            convnext_embed=args.convnext_embed,
            transunet_embed=args.transunet_embed,
            transunet_depth=args.transunet_depth,
            loss=args.loss,
        )
        if args.arch != "vanilla":
            cfg.model_name += f"_{args.arch}"
        if args.loss != "jsd":
            cfg.model_name += f"_{args.loss}"
        if cfg.resume:
            print("[simclutter] resume: newest checkpoint under "
                  f"{cfg.out_root} (if any)")
        train(cfg, policy=policy, datasets=datasets, device=dev)
        return

    if args.cmd == "zy3":
        cfg_yaml = generate_config(args.config, "zy3", argv=[])
        if args.choose_preprocess:
            _run_choose_preprocess(args, cfg_yaml, policy, dev)
            return
        _zy3(args, cfg_yaml, policy, dev)
        return

    if args.cmd == "nau":
        _nau(args, policy, dev)
        return


def _zy3(args, cfg_yaml, policy, dev):
    from onet_tpu_torch.core.checkpoint import datehour_mark
    from onet_tpu_torch.core.prng import make_generator
    from onet_tpu_torch.data.arrays import ArrayDataset
    from onet_tpu_torch.data.zy3 import load_zy3_dict_pt, synthesize_zy3
    from onet_tpu_torch.models.arch import get_arch
    from onet_tpu_torch.report import can_draw
    from onet_tpu_torch.train.zy3 import (Zy3Config, save_zy3_test_results,
                                          train)

    if args.cloud_addition:
        # cloud-addition workload: unsupervised training on composite
        # scenes (clean terrain + synthetic clouds) whose masks are
        # known by construction, so eval is exact. Reference dataset
        # class: CloudDataset_CloudAddition + its loader
        # (dataloader/zy3_cloud_thumbnailv5_20240304.py:262-309,338).
        from onet_tpu_torch.data.zy3 import synthesize_cloud_addition
        tr, _ = synthesize_cloud_addition(make_generator(0, dev),
                                          n=args.n_train, device=dev)
        train_ds = ArrayDataset({"imgs": tr["imgs"], "labels": tr["labels"]})
        te, test_ids = synthesize_cloud_addition(make_generator(1, dev),
                                                 n=args.n_test, device=dev)
        test_ds = ArrayDataset({"imgs": te["imgs"], "labels": te["labels"]})
        print(f"[zy3] cloud-addition composites: {args.n_train} train / "
              f"{args.n_test} test")
    else:
        train_file = args.train_file or os.path.join(
            cfg_yaml.dataset_root, cfg_yaml.train_file)
        test_file = args.test_file or os.path.join(
            cfg_yaml.dataset_root, cfg_yaml.test_file)
        if os.path.exists(train_file) and os.path.exists(test_file):
            train_ds, _ = load_zy3_dict_pt(train_file, device=dev)
            test_ds, test_ids = load_zy3_dict_pt(test_file, device=dev)
        else:
            print("[zy3] reference .pt files not found - "
                  "using synthetic scenes")
            train_ds, _ = synthesize_zy3(make_generator(0, dev), n=64,
                                         device=dev)
            test_ds, test_ids = synthesize_zy3(make_generator(1, dev), n=16,
                                               device=dev)
    cfg = Zy3Config(
        model_name=(cfg_yaml.model_name + "_cloudadd"
                    if args.cloud_addition else cfg_yaml.model_name),
        epoch_nums=args.epochs or cfg_yaml.epoch_nums,
        batch_sz=args.batch_sz or cfg_yaml.batch_sz,
        aug=bool(cfg_yaml.aug),
        base_lr=float(getattr(cfg_yaml, "base_lr", 1e-4)),
        out_root=args.out_root or cfg_yaml.out_root,
        base_channels=args.base_channels,
        # --restart-from, or the reference's YAML semantics:
        # restart: True reloads model_file
        # (Train_Onet_on_zy3_20240606.py:77-82)
        restart_from=(args.restart_from
                      or (getattr(cfg_yaml, "model_file", "")
                          if getattr(cfg_yaml, "restart", False)
                          else None) or None),
        arch=args.arch,
        swin_window=args.swin_window,
        swin_embed=args.swin_embed,
        convnext_embed=args.convnext_embed,
        transunet_embed=args.transunet_embed,
        transunet_depth=args.transunet_depth,
        loss=args.loss,
    )
    if args.arch != "vanilla":
        cfg.model_name += f"_{args.arch}"
    if args.loss != "jsd":
        cfg.model_name += f"_{args.loss}"
    params, bn_state, _ = train(cfg, train_ds, test_ds, policy=policy,
                                device=dev)
    # divided-testset Excel report with embedded thumbnails
    # (save_zy3_test_results_to_excel, uti_zy3_test_20240123.py:320-429)
    groups = _division(cfg_yaml, test_ids)
    excel_name = getattr(cfg_yaml, "res_excel_file", "zy3_results.xlsx")
    excel_path = os.path.join(
        cfg.out_root, excel_name.replace(".xlsx", f"_{datehour_mark()}.xlsx"))
    rep_arch = get_arch(args.arch, swin_window=args.swin_window,
                        swin_embed=args.swin_embed,
                        convnext_embed=args.convnext_embed,
                        transunet_embed=args.transunet_embed,
                        transunet_depth=args.transunet_depth)
    path, summary = save_zy3_test_results(
        excel_path, params, bn_state, test_ds, test_ids, groups,
        batch_sz=cfg.batch_sz, policy=policy, draw=can_draw(),
        epoch=cfg.epoch_nums - 1, model_name=cfg.model_name,
        forward=None if rep_arch.vanilla else rep_arch.forward)
    print(f"[zy3] report: {path}")
    print(summary.to_string(index=False))


def _probs_label(forward, get_label, params, state, x, policy):
    import torch
    with torch.no_grad(), policy.precision():
        return get_label(forward(params, state, x, train=False,
                                 policy=policy)[0].probs)


def _nau(args, policy, dev):
    import torch

    from onet_tpu_torch.core.checkpoint import (load_arch_auto,
                                                load_checkpoint,
                                                load_onet_auto)
    from onet_tpu_torch.core.config import generate_config
    from onet_tpu_torch.core.prng import make_generator
    from onet_tpu_torch.data.nau import load_nau_dict_pt, synthesize_nau_rain
    from onet_tpu_torch.metrics.segmentation import (
        align_labels_hungarian, evaluate_binary_segmentation)
    from onet_tpu_torch.models.onet import onet_init
    from onet_tpu_torch.report import can_draw
    from onet_tpu_torch.train.nau import make_transfer_eval, test_naurain

    if args.compare_fig and not can_draw():
        raise SystemExit("--compare-fig draws with matplotlib, which this "
                         "host does not have")
    cfg_yaml = generate_config(args.config, "naurain", argv=[])
    test_file = args.test_file or os.path.join(
        cfg_yaml.dataset_root, cfg_yaml.load_test_file)
    if os.path.exists(test_file):
        ds, ids = load_nau_dict_pt(test_file, device=dev)
    else:
        print("[nau] radar .pt not found - using synthetic rain frames")
        ds, ids = synthesize_nau_rain(make_generator(0, dev), n=10,
                                      device=dev)
    model = args.model or cfg_yaml.model_file
    fwd = None
    if model and os.path.exists(model):
        # checkpoint metadata picks the backbone family (arch record
        # for the ablation families; vanilla/torch by shape inference)
        arch, params, bn, _ = load_arch_auto(model, dev)
        fwd = None if arch.vanilla else arch.forward
        print(f"[nau] loaded {model} (arch {arch.name})")
    else:
        params, bn = onet_init(torch.Generator().manual_seed(1981), 1,
                               base=args.base_channels, device=dev)
        print("[nau] no checkpoint - evaluating a fresh model")
    out_root = args.out_root or cfg_yaml.out_root
    fig = os.path.join(out_root, "nau_rain_transfer.png")
    if can_draw():
        os.makedirs(out_root, exist_ok=True)
    out = test_naurain(params, bn, ds, batch_sz=cfg_yaml.batch_sz,
                       policy=policy, ids=ids,
                       fig_path=fig if can_draw() else None, forward=fwd)
    print(_round(out))

    # Baseline comparisons (the reference's revision figures pit Onet
    # against CFAR and InfoSeg on the same frames,
    # exp_nau_rain_20240513.py:177-261,312-533)
    labels_i = ds["labels"].to(torch.int32)
    baselines = {}  # name -> (pred [N,H,W], metrics)

    def add(name, pred, metrics=None):
        m = _round(metrics or evaluate_binary_segmentation(pred, labels_i))
        baselines[name] = (pred, m)
        return m

    gen0 = torch.Generator().manual_seed(0)
    if args.infoseg is not None:
        from onet_tpu_torch.models.infoseg import (
            get_label, infoseg_forward, infoseg_init)
        ip, istate = infoseg_init(gen0, args.in_channels,
                                  base=args.base_channels, device=dev)
        ip, istate, _ = load_checkpoint(args.infoseg, ip, istate)
        m = add("InfoSeg", align_labels_hungarian(_probs_label(
            infoseg_forward, get_label, ip, istate, ds["imgs"], policy),
            labels_i))
        print(f"[nau] InfoSeg baseline ({args.infoseg}): {m}")
    if args.iic is not None:
        from onet_tpu_torch.models.iic import (
            get_label as iic_get_label, iic_forward, iic_init)
        qp, qstate = iic_init(torch.Generator().manual_seed(0),
                              args.in_channels, base=args.base_channels,
                              device=dev)
        qp, qstate, _ = load_checkpoint(args.iic, qp, qstate)
        m = add("IIC", align_labels_hungarian(_probs_label(
            iic_forward, iic_get_label, qp, qstate, ds["imgs"], policy),
            labels_i))
        print(f"[nau] IIC baseline ({args.iic}): {m}")
    if args.cfar is not None:
        from onet_tpu_torch.metrics.cfar import cfar_seg_batch
        m = add("CFAR", cfar_seg_batch(ds["imgs"], args.cfar))
        print(f"[nau] CA-CFAR baseline (kval {args.cfar:g}, nref 16, "
              f"mguide 8): {m}")
    if args.model_tw is not None:
        tw_p, tw_bn, _ = load_onet_auto(args.model_tw, dev)
        _, _, pred, _ = make_transfer_eval(policy=policy)(
            tw_p, tw_bn, ds["imgs"], ds["labels"])
        m = add("Onet_TW", pred)
        print(f"[nau] Onet_TW ({args.model_tw}): {m}")
    if args.model2 is not None:
        from onet_tpu_torch.train.two_stage import make_two_stage_eval
        p2, bn2, _ = load_onet_auto(args.model2, dev)
        _, m2, _, pred2, _ = make_two_stage_eval(policy=policy)(
            params, bn, p2, bn2, ds["imgs"], ds["labels"])
        m = add("Onet2", pred2, m2)
        print(f"[nau] Onet2 two-stage ({args.model2}): {m}")
    if args.compare_fig:
        from onet_tpu_torch.report.curves import save_method_comparison_grid
        _, _, onet_pred, _ = make_transfer_eval(policy=policy)(
            params, bn, ds["imgs"], ds["labels"])
        methods = {k: _host(v[0]) for k, v in baselines.items()}
        fars = {k: v[1]["far"] for k, v in baselines.items()}
        methods["Onet"] = _host(onet_pred)
        fars["Onet"] = round(float(out["far"]), 4)
        cmp_path = os.path.join(out_root,
                                "exp_naurain_method_comparison.png")
        save_method_comparison_grid(
            cmp_path, _host(ds["imgs"][..., 0]), _host(ds["labels"]),
            methods, fars)
        print(f"[nau] comparison figure: {cmp_path}")
    print(f"[nau] figure: "
          f"{fig if can_draw() else 'not drawn (no matplotlib)'}")


def _serve(args, policy, dev):
    import time

    import torch

    from onet_tpu_torch.core.checkpoint import (load_checkpoint,
                                                load_onet_auto,
                                                read_checkpoint_meta)
    from onet_tpu_torch.models.arch import arch_from_meta
    from onet_tpu_torch.models.infer import fold_onet, onet_infer
    from onet_tpu_torch.models.onet import predict_label
    from onet_tpu_torch.serve.artifact import is_artifact

    artifact_mode = is_artifact(args.model)
    if artifact_mode:
        # artifact serving: the file IS the model — no checkpoint load, no
        # fold, no backbone code (serve/artifact.py)
        from onet_tpu_torch.serve.artifact import load_serving_artifact
        if args.int8:
            raise SystemExit(
                "--int8 quantizes a checkpoint's folded graph; an "
                "artifact's arithmetic is already baked in "
                "(export a quantized one: export-artifact --int8)")
        acall, ameta = load_serving_artifact(args.model, dev)
        print(f"[serve] artifact {args.model}: "
              f"{ameta.get('arithmetic', 'bf16')}, input "
              f"[{ameta['batch']}, {ameta['input_hw'][0]}, "
              f"{ameta['input_hw'][1]}, {ameta['in_channels']}], "
              f"exported from {ameta.get('model', '?')}")
    # the checkpoint's own metadata picks the backbone family
    # (models/arch.py; npz files written by the train drivers carry it;
    # meta-less / torch checkpoints are the vanilla conv U-Net)
    meta = {} if artifact_mode else read_checkpoint_meta(args.model)
    arch = arch_from_meta(meta)
    if artifact_mode:
        pass
    elif not arch.vanilla:
        if args.int8:
            raise SystemExit(
                f"--int8 serving quantizes the folded conv U-Net; the "
                f"checkpoint is --arch {arch.name} (bf16/fp32 serving, "
                "the detector, --tile and --http all work)")
        in_ch = meta.get("in_channels", args.in_channels)
        params, bn = arch.init(
            torch.Generator().manual_seed(0), in_ch,
            weight_share=meta.get("weight_share", True), device=dev)
        params, bn, _ = load_checkpoint(args.model, params, bn)
        print(f"[serve] arch {arch.name} from checkpoint metadata")
    else:
        # vanilla checkpoints self-describe: width/channels/twin-ness
        # come from the file's own shapes
        params, bn, _ = load_onet_auto(args.model, dev)
        with torch.no_grad():
            folded = fold_onet(params, bn)
    if args.input:
        if not os.path.exists(args.input):
            raise SystemExit(f"--input {args.input}: no such file")
        imgs = np.load(args.input)["imgs"].astype(np.float32)
    else:
        if artifact_mode and not args.tile and (
                tuple(ameta["input_hw"]) != (224, 224)
                or ameta["in_channels"] != 1):
            raise SystemExit(
                "the synthetic-frame fallback generates 224^2 "
                "grayscale clutter, but this artifact expects "
                f"[{ameta['input_hw'][0]}, {ameta['input_hw'][1]}, "
                f"{ameta['in_channels']}] inputs — pass --input")
        from onet_tpu_torch.train.sweeps import per_snr_datasets
        data = per_snr_datasets(7, frames_per_level=16, levels=(5, 10),
                                device=dev)
        imgs = np.concatenate([_host(d["imgs"]) for d in data.values()])
        print(f"[serve] no --input; {imgs.shape[0]} synthetic frames")
    if artifact_mode:
        # keep the (model_arg, xb) step contract so the detector /
        # tiling / http pipeline below composes unchanged
        step = lambda _m, xb, _c=acall: _c(xb)   # noqa: E731
        model_arg = None
    elif args.int8:
        from onet_tpu_torch.models.quant import (
            calibrate, onet_infer_q, quantize_folded)
        with torch.no_grad():
            scales = calibrate(folded, torch.as_tensor(
                imgs[:args.serve_batch]).to(dev))
            model_arg = quantize_folded(folded, scales)
        step = onet_infer_q
    elif not arch.vanilla:
        # stateless backbones serve their plain forward (no BN to fold);
        # step keeps the (S, labels) contract of onet_infer
        def step(m, xb, _fwd=arch.forward):
            with policy.precision():
                out, _ = _fwd(m[0], m[1], xb, train=False, policy=policy)
            return out.S, predict_label(out.S)

        model_arg = (params, bn)
    else:
        def step(f, xb):
            return onet_infer(f, xb, policy=policy)

        model_arg = folded
    if args.far_budget:
        # threshold detector (metrics/roc.py): serve detections at a
        # false-alarm budget. Threshold = clutter-score quantile (targets
        # are sparse, so the all-pixel quantile is the clutter quantile to
        # O(target fraction)).
        import json as _json

        from onet_tpu_torch.metrics.roc import quantile
        fg = 1 if args.fg == "down" else 0
        base_step = step

        def score_of(s):
            return (torch.log(s[..., fg] + 1e-9)
                    - torch.log(s[..., 1 - fg] + 1e-9))

        sidecar = args.model + ".detector.json"
        thr = None
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                d = _json.load(f)
            if (d.get("far_budget") == args.far_budget
                    and d.get("fg") == args.fg
                    and d.get("int8") == bool(args.int8)):
                thr = d["threshold"]
                print(f"[serve] detector threshold {thr:.4f} "
                      f"from {sidecar}")
        if thr is None:
            calib = (imgs[:args.serve_batch] if imgs.ndim == 4
                     else imgs[None, :, :, :])
            if args.tile:
                # tiled mode: calibrate on window-sized center crops so
                # the untiled step never runs at full scene size
                win = args.tile + 2 * args.halo
                h, w = calib.shape[1:3]
                ch, cw = min(h, win), min(w, win)   # clamp PER dim
                if (ch, cw) != (h, w):
                    y0, x0 = (h - ch) // 2, (w - cw) // 2
                    calib = calib[:, y0:y0 + ch, x0:x0 + cw]
            with torch.inference_mode():
                s0, _ = base_step(model_arg, torch.as_tensor(
                    np.ascontiguousarray(calib)).to(dev))
                thr = float(quantile(score_of(s0).reshape(-1),
                                     1.0 - args.far_budget))
            with open(sidecar, "w") as f:
                _json.dump({"far_budget": args.far_budget,
                            "fg": args.fg, "int8": bool(args.int8),
                            "threshold": thr}, f)
            print(f"[serve] calibrated detector threshold {thr:.4f} "
                  f"@ far<={args.far_budget:g} -> {sidecar}")

        def step(m, xb, _thr=thr):
            s, _ = base_step(m, xb)
            return s, (score_of(s) > _thr).to(torch.int32)

    mode = (f"artifact:{ameta.get('arithmetic', '?')}" if artifact_mode
            else "int8" if args.int8 else "bf16" if args.bf16 else "fp32")
    if args.far_budget:
        mode += f"+detector@far{args.far_budget:g}"
    if args.http is not None:
        # resident daemon: the step stays warm and answers npy-over-HTTP
        # (serve/http.py). The pipeline above (int8 / detector / tiling)
        # is exactly what gets served.
        from onet_tpu_torch.serve.http import ServingSession, start_server
        sess = ServingSession(
            step, model_arg, batch=args.serve_batch,
            in_channels=(ameta["in_channels"] if artifact_mode
                         else args.in_channels), mode=mode,
            model_name=os.path.basename(args.model),
            tile=args.tile, halo=args.halo,
            input_hw=(tuple(ameta["input_hw"])
                      if artifact_mode and not args.tile
                      else tuple(imgs.shape[1:3])), device=dev)
        sess.warmup()
        httpd = start_server(sess, args.http)
        host, port = httpd.server_address[:2]
        print(f"[serve:http] {mode} listening on http://{host}:{port} "
              f"(batch {args.serve_batch}, warm at "
              f"{sess.input_hw[0]}x{sess.input_hw[1]})", flush=True)
        try:
            if args.http_requests:
                for _ in range(args.http_requests):
                    httpd.handle_request()
            else:
                httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
        return
    masks, n, t0 = [], 0, time.perf_counter()
    with torch.inference_mode():
        if args.tile:
            from onet_tpu_torch.serve import infer_tiled
            for scene in imgs:
                m = infer_tiled(step, model_arg, scene, tile=args.tile,
                                halo=args.halo, batch=args.serve_batch,
                                device=dev)
                masks.append(m[None].astype(np.uint8))
                n += 1
        else:
            lat = []
            for i in range(0, imgs.shape[0], args.serve_batch):
                tb = time.perf_counter()
                chunk = imgs[i:i + args.serve_batch]
                got = chunk.shape[0]
                if got < args.serve_batch:
                    # pad the ragged tail to the one batch shape (pinned-
                    # batch artifacts require it)
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:],
                                          args.serve_batch - got, axis=0)])
                xb = torch.as_tensor(np.ascontiguousarray(chunk)).to(dev)
                _, labels = step(model_arg, xb)
                masks.append(_host(labels)[:got].astype(np.uint8))
                lat.append(time.perf_counter() - tb)
                n += got
            if len(lat) > 2:
                # per-batch serving latency (the host read of the labels
                # waits for the device); the first batch builds and warms
                warm = np.asarray(lat[1:]) * 1e3
                print(f"[serve] latency/batch p50 "
                      f"{np.percentile(warm, 50):.1f} ms p95 "
                      f"{np.percentile(warm, 95):.1f} ms (first incl. "
                      f"warm-up {lat[0] * 1e3:.0f} ms)")
    dt = time.perf_counter() - t0
    masks = np.concatenate(masks)
    np.savez(args.out, masks=masks)
    print(f"[serve:{mode}] {n} frames in {dt:.2f}s "
          f"({n / dt:.1f} frames/s incl. warm-up) -> {args.out}")


if __name__ == "__main__":
    main()
