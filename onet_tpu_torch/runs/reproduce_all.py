"""One-command reproduction of the reference's entire published protocol
(``runs/reproduce_all.py`` of the JAX package, over the port's libraries).

Chains every workload of the reference recipe end-to-end and writes a
consolidated report placing each measured number beside its reference
anchor (file:line in the reference's sources, and the published figure
where its README states one):

  1. gen-data          rayleigh_2sigma-schema .pt from the device generator
                       [Rayleigh_bg_Gaussian_EOT_generator_20230208.py
                        prepare_data]
  2. simclutter PSNR0-2  the low-SNR weight-share model
                       [Train_Onet_on_simclutter_20250407.py:640-671]
  3. simclutter PSNR5-10 the high-SNR model
                       [Train_Onet_on_simclutter_20250407.py:674-687]
  4. per-PSNR verify of both models
                       [verify_onet_simclutter, :420-454]
  5. two-stage composition verify (stage1 = low-SNR, stage2 = high-SNR)
                       [:296-418,672-685]
  6. NAU-rain zero-shot transfer of the LOW-SNR model + the CFAR /
     InfoSeg / IIC comparison surface
                       [exp_nau_rain_20240513.py:177-261,312-533]
  7. zy3 11-epoch training + divided-testset xlsx
                       [Train_Onet_on_zy3_20240606.py:404-458]
  8. raw-imagery on-ramp + preprocessing selection
                       [test_pre_processing_on_zy3_testset_20240607.py:
                        99-184,359-472,506-562]

Scales (``SCALES``): micro (the CPU chain check), smoke (minutes on the
card at the protocol's full geometry; numbers NOT converged) and paper
(the published protocol, hours).

ZY-3 / NAU imagery: no real .pt dicts ship with the repository, so those
stages run on schema-identical synthetic stand-ins; drop the real files
at the ``datasets/`` paths below and the same command consumes them.
Nothing is downloaded.

  python -m onet_tpu_torch.runs.reproduce_all --scale smoke [--device cuda]

(also ``python -m onet_tpu_torch.run reproduce [--scale ...]``). Writes
<out>/REPRODUCE.md + reproduce.json (the JAX package's schema, "backend"
being the device's name) + every per-stage artifact. Figures are drawn
where matplotlib is installed (``report.can_draw``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

# full-scale model/frame geometry, shared by smoke and paper so the smoke
# rehearsal can never desynchronize from the protocol it rehearses
_FULL_GEOM = dict(base=64, crop=224, nau_size=200, zy3_n=(32, 12),
                  scene_size=384, resize=300)

SCALES = {
    # epochs: (sim, baseline(infoseg/iic), zy3); frames per PSNR level;
    # scenes for the on-ramp; frames/level in the verify sweeps.
    # base/crop size the model and frames; micro exists for the CPU chain
    # test — it proves stage chaining, nothing about convergence.
    "micro": dict(sim_epochs=2, base_epochs=1, zy3_epochs=1,
                  frames=2, sweep_frames=2, scenes=3, batch=2,
                  eval_every=1, base=8, crop=32, nau_size=48,
                  zy3_n=(6, 6), scene_size=48, resize=44),
    "smoke": dict(sim_epochs=6, base_epochs=6, zy3_epochs=3,
                  frames=8, sweep_frames=6, scenes=6, batch=8,
                  eval_every=5, **_FULL_GEOM),
    "paper": dict(sim_epochs=301, base_epochs=60, zy3_epochs=11,
                  frames=150, sweep_frames=150, scenes=12, batch=10,
                  eval_every=50, **_FULL_GEOM),
}

ANCHORS = {
    "gen_data": "Rayleigh_bg_Gaussian_EOT_generator_20230208.py "
                "prepare_data (rayleigh_2sigma.pt schema)",
    "sim_low": "Train_Onet_on_simclutter_20250407.py:640-671 "
               "(onet_weight_share_PSNR0-2, 301 epochs)",
    "sim_high": "Train_Onet_on_simclutter_20250407.py:674-687 "
                "(onet_weight_share_PSNR5-10)",
    "sweep": "Train_Onet_on_simclutter_20250407.py:420-454 "
             "(verify_onet_simclutter per-PSNR table)",
    "two_stage": "Train_Onet_on_simclutter_20250407.py:296-418,672-685 "
                 "(verify_2nd_stage_onet)",
    "nau": "exp_nau_rain_20240513.py:177-261,312-533 (transfer of "
           "onet_lowsnr0-2 + CFAR/InfoSeg/IIC comparison)",
    "zy3": "Train_Onet_on_zy3_20240606.py:404-458; README.md:95 "
           "(11 epochs -> OA 0.8833 / miou 0.7218 on real ZY-3)",
    "choose_preprocess": "test_pre_processing_on_zy3_testset_20240607.py:"
                         "99-184,359-472,506-562; README.md:95 "
                         "(OA 0.9254 / miou 0.7958 after pre-processing "
                         "on real ZY-3)",
}


def _stage(report, name, fn):
    t0 = time.time()
    print(f"\n=== [{name}] {ANCHORS[name]}")
    out = fn()
    rec = {"seconds": round(time.time() - t0, 1), "anchor": ANCHORS[name]}
    rec.update(out or {})
    report["stages"][name] = rec
    print(f"=== [{name}] done in {rec['seconds']}s")
    return rec


def _rounded(metrics) -> dict:
    return {k: round(float(v), 4) for k, v in metrics.items()}


def write_scenes(src_dir, mask_dir, imgs, masks, ids, haze_every=2):
    """Raw ZY-3-like scenes for the on-ramp: scene_<id>.jpg +
    label_<id>.png pairs in the reference's filename-id convention, every
    ``haze_every``-th one degraded with an airlight haze layer
    (I*t + A*(1-t)) so the dehaze options have signal to recover
    (``runs/onramp_scenes.py::write_scenes`` of the JAX package)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(11)
    os.makedirs(src_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    for i, (img, mask, pid) in enumerate(zip(imgs, masks, ids)):
        img = np.asarray(img, np.float32)
        if i % haze_every == 1:  # haze half the scenes
            t = float(rng.uniform(0.5, 0.75))
            img = img * t + 0.92 * (1.0 - t)
        u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(u8).save(os.path.join(src_dir, f"scene_{pid}.jpg"),
                                 quality=95)
        m8 = (np.asarray(mask) > 0.5).astype(np.uint8) * 255
        Image.fromarray(m8).save(os.path.join(mask_dir, f"label_{pid}.png"))


def run(scale: str, out_root: str, device=None):
    import numpy as np
    import torch

    from onet_tpu_torch.core.cache import enable_compilation_cache
    from onet_tpu_torch.core.device import resolve_device
    from onet_tpu_torch.core.policy import BF16_COMPUTE as policy
    from onet_tpu_torch.core.prng import make_generator
    from onet_tpu_torch.report import can_draw

    enable_compilation_cache()
    dev = resolve_device(device)
    draw = can_draw()
    S = SCALES[scale]
    os.makedirs(out_root, exist_ok=True)
    report = {"scale": scale, "params": S,
              "backend": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else dev.type),
              "stages": {}}

    # -- 1. gen-data -------------------------------------------------------
    def gen_data():
        from onet_tpu_torch.data.export import export_simclutter_pt
        from onet_tpu_torch.sim.rayleigh import generate_rayleigh_dataset
        d = generate_rayleigh_dataset(
            make_generator(1981, dev), levels=tuple(range(0, 11)),
            frames_per_level=S["frames"], crop=S["crop"], device=dev)
        path = export_simclutter_pt(
            os.path.join(out_root, "rayleigh_2sigma.pt"), d)
        return {"file": path, "frames": int(d["imgs"].shape[0])}

    _stage(report, "gen_data", gen_data)

    # -- 2/3. simclutter low + high ---------------------------------------
    from onet_tpu_torch.train.simclutter import SimclutterConfig
    from onet_tpu_torch.train.simclutter import train as sim_train

    models = {}

    def train_sim(tag, lo, hi):
        cfg = SimclutterConfig(
            model_name=f"onet_weight_share_PSNR{lo}-{hi}",
            epoch_nums=S["sim_epochs"], batch_sz=S["batch"],
            input_sz=S["crop"], base_channels=S["base"],
            low_snr=lo, high_snr=hi, frames_per_level=S["frames"],
            eval_every=S["eval_every"],
            out_root=os.path.join(out_root, "sim_clutter"),
            save_epochs=(S["sim_epochs"] - 1,))
        params, bn, hist = sim_train(cfg, policy=policy, device=dev)
        models[tag] = (params, bn)
        return {"final_eval": _rounded(hist["eval"][max(hist["eval"])])}

    _stage(report, "sim_low", lambda: train_sim("low", 0, 2))
    _stage(report, "sim_high", lambda: train_sim("high", 5, 10))

    # -- 4. per-PSNR verify ------------------------------------------------
    from onet_tpu_torch.train.sweeps import per_snr_datasets, test_by_snr

    data_by_snr = per_snr_datasets(7, frames_per_level=S["sweep_frames"],
                                   crop=S["crop"], device=dev)

    def sweep():
        out = {}
        for name, tag in (("PSNR0-2", "low"), ("PSNR5-10", "high")):
            rep = test_by_snr(*models[tag], data_by_snr, policy=policy)
            out[name] = {str(k): _rounded(rep[k]) for k in rep}
            a = rep["ave"]
            print(f"  {name}: ave acc {a['acc']:.4f} miou {a['miou']:.4f} "
                  f"dr {a['dr']:.4f} far {a['far']:.4f}")
        return out

    _stage(report, "sweep", sweep)

    # -- 5. two-stage ------------------------------------------------------
    def two_stage():
        from onet_tpu_torch.train.two_stage import verify_two_stage
        rep = verify_two_stage(*models["low"], *models["high"], data_by_snr,
                               batch_sz=S["batch"], policy=policy)
        a = rep["ave"]
        print(f"  stage1 acc {a['stage1']['acc']:.4f} -> "
              f"stage2 acc {a['stage2']['acc']:.4f} "
              f"(far {a['stage1']['far']:.2E} -> {a['stage2']['far']:.2E})")
        return {"ave": {s: _rounded(m) for s, m in a.items()}}

    _stage(report, "two_stage", two_stage)

    # -- 6. NAU transfer + comparison surface ------------------------------
    def nau():
        from onet_tpu_torch.data.nau import (load_nau_dict_pt,
                                             synthesize_nau_rain)
        from onet_tpu_torch.metrics.cfar import cfar_seg_batch
        from onet_tpu_torch.metrics.segmentation import (
            align_labels_hungarian, evaluate_binary_segmentation)
        from onet_tpu_torch.models.iic import get_label as iic_label
        from onet_tpu_torch.models.iic import iic_forward
        from onet_tpu_torch.models.infoseg import get_label as info_label
        from onet_tpu_torch.models.infoseg import infoseg_forward
        from onet_tpu_torch.train.iic import IICConfig
        from onet_tpu_torch.train.iic import train as iic_train
        from onet_tpu_torch.train.infoseg import InfoSegConfig
        from onet_tpu_torch.train.infoseg import train as info_train
        from onet_tpu_torch.train.nau import test_naurain

        real = os.path.join(
            "datasets", "naurain_20200819144753_10_target_img_label_dict.pt")
        if os.path.exists(real):
            ds, ids = load_nau_dict_pt(real, device=dev)
            src = real
            comp = "reference-comparable (real NAU .pt)"
        else:
            ds, ids = synthesize_nau_rain(make_generator(0, dev), n=10,
                                          size=S["nau_size"], device=dev)
            src = "synthetic stand-in (no real NAU .pt in snapshot)"
            comp = "synthetic-data"
        fig = os.path.join(out_root, "nau_rain_transfer.png")
        onet_m = test_naurain(*models["low"], ds, batch_sz=5, policy=policy,
                              ids=ids, fig_path=fig if draw else None)
        labels_i = ds["labels"].to(torch.int32)
        rows = {"Onet": _rounded(onet_m)}
        rows["CFAR"] = _rounded(evaluate_binary_segmentation(
            cfar_seg_batch(ds["imgs"], 2.0), labels_i))

        base = dict(epoch_nums=S["base_epochs"], batch_sz=S["batch"],
                    input_sz=S["crop"], base_channels=S["base"],
                    frames_per_level=S["frames"])
        for name, cfg_cls, train, forward, label in (
                ("InfoSeg", InfoSegConfig, info_train, infoseg_forward,
                 info_label),
                ("IIC", IICConfig, iic_train, iic_forward, iic_label)):
            p, st, _ = train(cfg_cls(**base), policy=policy, log=False,
                             device=dev)
            with torch.no_grad(), policy.precision():
                probs = forward(p, st, ds["imgs"], train=False,
                                policy=policy)[0].probs
            pred = align_labels_hungarian(label(probs), labels_i)
            rows[name] = _rounded(evaluate_binary_segmentation(pred,
                                                               labels_i))

        for name, m in rows.items():
            print(f"  {name:8s} acc {m['acc']:.4f} miou {m['miou']:.4f} "
                  f"dr {m['dr']:.4f} far {m['far']:.4f}")
        return {"data": src, "comparability": comp, "methods": rows,
                "figure": fig if draw else None}

    _stage(report, "nau", nau)

    # -- 7. zy3 ------------------------------------------------------------
    zy3_ckpt = {}

    def zy3():
        from onet_tpu_torch.core.checkpoint import save_checkpoint
        from onet_tpu_torch.data.zy3 import load_zy3_dict_pt, synthesize_zy3
        from onet_tpu_torch.train.zy3 import (GROUP_NAMES, Zy3Config,
                                              save_zy3_test_results)
        from onet_tpu_torch.train.zy3 import train as zy3_train

        tf = os.path.join("datasets", "zy3_train.pt")
        sf = os.path.join("datasets", "zy3_test.pt")
        if os.path.exists(tf) and os.path.exists(sf):
            train_ds, _ = load_zy3_dict_pt(tf, device=dev)
            test_ds, test_ids = load_zy3_dict_pt(sf, device=dev)
            src = tf
            comp = "reference-comparable (real ZY-3 .pt)"
        else:
            train_ds, _ = synthesize_zy3(make_generator(0, dev),
                                         n=S["zy3_n"][0], size=S["crop"],
                                         device=dev)
            test_ds, test_ids = synthesize_zy3(make_generator(1, dev),
                                               n=S["zy3_n"][1],
                                               size=S["crop"], device=dev)
            src = "synthetic stand-in (no real ZY-3 .pt in snapshot)"
            comp = "synthetic-data"
        cfg = Zy3Config(model_name="onet_vanilla_zy3",
                        epoch_nums=S["zy3_epochs"],
                        batch_sz=min(4, S["batch"]),
                        input_sz=S["crop"], base_channels=S["base"],
                        out_root=os.path.join(out_root, "zy3"))
        params, bn, hist = zy3_train(cfg, train_ds, test_ds, policy=policy,
                                     device=dev)
        ck = os.path.join(out_root, "zy3", "onet_zy3_reproduce.npz")
        save_checkpoint(ck, params, bn, cfg.epoch_nums - 1)
        zy3_ckpt["path"] = ck
        groups = {g: [test_ids[i] for i in range(gi, len(test_ids), 3)]
                  for gi, g in enumerate(GROUP_NAMES)}
        xlsx, _ = save_zy3_test_results(
            os.path.join(out_root, "zy3", "zy3_results.xlsx"),
            params, bn, test_ds, test_ids, groups,
            batch_sz=min(4, S["batch"]),
            policy=policy, draw=draw, epoch=cfg.epoch_nums - 1,
            model_name=cfg.model_name)
        last = hist["eval"][max(hist["eval"])]
        print(f"  zy3 {S['zy3_epochs']}-epoch: acc "
              f"{last['acc']:.4f} miou {last['miou']:.4f} ({src})")
        return {"data": src, "comparability": comp, "xlsx": xlsx,
                "final_eval": _rounded(last)}

    _stage(report, "zy3", zy3)

    # -- 8. on-ramp + preprocessing selection ------------------------------
    def choose_preprocess():
        from onet_tpu_torch.core.checkpoint import load_arch_auto
        from onet_tpu_torch.data.zy3 import synthesize_zy3
        from onet_tpu_torch.preprocess.onramp import (
            choose_preprocess as choose, id_from_filename, list_scene_files)
        from onet_tpu_torch.train.zy3 import GROUP_NAMES

        real_src = os.path.join("datasets", "zy3_scenes", "src")
        real_masks = os.path.join("datasets", "zy3_scenes", "masks")
        if list_scene_files(real_src) and list_scene_files(real_masks):
            # real raw scenes dropped at the documented path: consume them
            # (test_pre_processing_on_zy3_testset_20240607.py:506-520 reads
            # the raw testset50 directory the same way)
            scene_root = os.path.dirname(real_src)
            src_files = list_scene_files(real_src)
            mask_files = list_scene_files(real_masks)
            ids = [id_from_filename(f) for f in src_files]
            comp = "reference-comparable (real ZY-3 scenes)"
        else:
            scene_root = os.path.join(out_root, "onramp")
            ds_te, _ = synthesize_zy3(make_generator(4102, dev),
                                      n=S["scenes"], size=S["scene_size"],
                                      device=dev)
            ids = [f"{1710000000 + i}" for i in range(S["scenes"])]
            write_scenes(os.path.join(scene_root, "src"),
                         os.path.join(scene_root, "masks"),
                         ds_te["imgs"].cpu().numpy(),
                         ds_te["labels"].cpu().numpy(), ids)
            src_files = list_scene_files(os.path.join(scene_root, "src"))
            mask_files = list_scene_files(os.path.join(scene_root, "masks"))
            comp = "synthetic-data"
        _, params, bn, _ = load_arch_auto(zy3_ckpt["path"], dev)
        gids = ["zy3_test_" + i for i in ids]
        groups = {g: [gids[i] for i in range(gi, len(gids), 3)]
                  for gi, g in enumerate(GROUP_NAMES)}
        _, rows = choose(params, bn, src_files, mask_files,
                         groups=groups, policy=policy, progress=False,
                         resize_to=S["resize"], crop=S["crop"], device=dev)
        mean_acc = float(np.mean([r["acc"] for r in rows]))
        mean_miou = float(np.mean([r["miou"] for r in rows]))
        base_acc = float(np.mean([r["base_acc"] for r in rows])) \
            if "base_acc" in rows[0] else None
        base_miou = float(np.mean([r["base_miou"] for r in rows])) \
            if "base_miou" in rows[0] else None
        picked = sorted({r["opt"] for r in rows})
        # base_* are None when raw_rgb is not in the scored option set
        # (possible through onramp.py's options kwarg, never the default)
        fmt = lambda v: f"{v:.4f}" if v is not None else "n/a"  # noqa: E731
        print(f"  selected options {picked}: acc "
              f"{fmt(base_acc)} -> {mean_acc:.4f} miou "
              f"{fmt(base_miou)} -> {mean_miou:.4f} after pre-processing")
        rnd = lambda v: round(v, 4) if v is not None else None  # noqa: E731
        return {"acc_after": round(mean_acc, 4),
                "miou_after": round(mean_miou, 4),
                "acc_before": rnd(base_acc),
                "miou_before": rnd(base_miou),
                "options_selected": picked,
                "data": scene_root, "comparability": comp}

    _stage(report, "choose_preprocess", choose_preprocess)

    # -- consolidated report ----------------------------------------------
    with open(os.path.join(out_root, "reproduce.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    _write_md(report, out_root)
    print(f"\n[reproduce] report: {os.path.join(out_root, 'REPRODUCE.md')}")
    return report


def _write_md(report, out_root):
    st = report["stages"]
    lines = [
        "# Full-protocol reproduction — scale: %s" % report["scale"],
        "",
        "One command (`python -m onet_tpu_torch.run reproduce --scale %s`, "
        "on %s) chains" % (report["scale"], report["backend"]),
        "the reference's entire published recipe; every number below sits",
        "beside its reference anchor. The comparability column flags which",
        "rows ran on the reference's own data protocol (the simulated-",
        "clutter stages use the same published generator recipe the",
        "reference trains on) vs schema-exact synthetic stand-ins for the",
        "real-imagery workloads — stand-in rows prove the pipeline, NOT the",
        "published figure.",
        "",
        "| stage | ours | comparability | reference anchor |",
        "|---|---|---|---|",
    ]

    # Simulated-clutter stages run the reference's own generator protocol;
    # real-imagery stages carry whatever the stage detected at run time.
    SIM_COMP = "reference-comparable (published simulator protocol)"

    def row(key, label, ours):
        comp = st[key].get("comparability", SIM_COMP)
        lines.append(f"| {label} | {ours} | {comp} | {st[key]['anchor']} |")

    row("gen_data", "gen-data",
        f"{st['gen_data']['frames']} frames -> "
        f"`{os.path.basename(st['gen_data']['file'])}`")
    for k, label in (("sim_low", "simclutter PSNR0-2"),
                     ("sim_high", "simclutter PSNR5-10")):
        e = st[k]["final_eval"]
        row(k, label, f"acc {e['acc']} miou {e['miou']} dr {e['dr']} "
                      f"far {e['far']}")
    for name, rep in st["sweep"].items():
        if name in ("seconds", "anchor", "comparability"):
            continue
        a = rep["ave"]
        row("sweep", f"per-PSNR verify ({name})",
            f"ave acc {a['acc']} miou {a['miou']} dr {a['dr']} "
            f"far {a['far']}")
    a = st["two_stage"]["ave"]
    row("two_stage", "two-stage",
        f"stage1 acc {a['stage1']['acc']} far "
        f"{a['stage1']['far']} -> stage2 acc "
        f"{a['stage2']['acc']} far {a['stage2']['far']}")
    for m, v in st["nau"]["methods"].items():
        row("nau", f"NAU transfer — {m}",
            f"acc {v['acc']} miou {v['miou']} dr {v['dr']} far {v['far']}")
    e = st["zy3"]["final_eval"]
    row("zy3", "zy3 (%d epochs)" % report["params"]["zy3_epochs"],
        f"acc {e['acc']} miou {e['miou']}")
    c = st["choose_preprocess"]
    row("choose_preprocess", "preprocess selection",
        f"acc {c['acc_before']} -> {c['acc_after']} "
        f"miou {c['miou_before']} -> {c['miou_after']} "
        f"(options {c['options_selected']})")
    lines += [
        "",
        "Stage wall times: "
        + ", ".join(f"{k} {v['seconds']}s" for k, v in st.items()),
        "",
        "Data provenance: " + "; ".join(
            f"{k}: {st[k]['data']}"
            for k in ("nau", "zy3", "choose_preprocess")
            if "data" in st[k]),
    ]
    with open(os.path.join(out_root, "REPRODUCE.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=sorted(SCALES), default="smoke")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = args.out or os.path.join("runs", f"reproduce_{args.scale}")
    run(args.scale, out, device=args.device)


if __name__ == "__main__":
    main()
