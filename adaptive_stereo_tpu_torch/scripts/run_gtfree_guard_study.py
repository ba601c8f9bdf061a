"""GT-free divergence detection study on the port (counterpart of
scripts/run_gtfree_guard_study.py).

Measures GT-free candidate channels for divergence detection on the
deterministic collapse run of the paper-scale protocol (the fused-f32 VS
run, whose OVS loss stays flat while the train EPE climbs) and on the
faithful-VS and VS+ER comparators, every `--probe_hz` steps:

  grad_norm    stereo-net gradient norm of the Monodepth loss on a FIXED
               probe frame
  drift        relative parameter drift ||theta_t - theta_0|| / ||theta_0||
  lr_cons      left-right cross-consistency: mean |warp(d_r, d_l) - d_l|
               over the warp validity mask on the probe frame
  fcs          FCS of the probe frame
  mean_disp    mean |d_l|
  epe          probe-frame EPE against the synthetic GT: the label for
               collapse onset (study-only; not available in deployment)

The probes run at the driver's drain boundaries (adapt_streaming's
probe_hook), in eval mode, on a model of their own loaded from the live
variables: no running statistics move, no gradient lands on the live
model, and nothing is drawn from the driver's generators, so the
trajectory is the one without probes.

Usage (expects phases 0-2 of run_paper_scale_synth in --work /
--artifacts; writes probes_<config>.csv under --out):

  python -m adaptive_stereo_tpu_torch.scripts.run_gtfree_guard_study \\
      --work $WORK --artifacts $WORK/artifacts --out $WORK/gtfree_study \\
      [--configs fused faithful vser] [--device cpu]

The flags are the JAX script's with its defaults, plus --device, except
--out, whose default is in the temporary directory instead of the
repository's artifacts/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "paper_scale_r4"))
    p.add_argument("--artifacts", default="artifacts/paper_scale_r4")
    # JAX's default is the repository's artifacts/gtfree_study_r5, which holds
    # the JAX package's results: the port writes its CSVs in the temporary
    # directory unless told otherwise.
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "gtfree_study_r5"))
    p.add_argument("--configs", nargs="*", default=["fused", "faithful"])
    p.add_argument("--adapt_steps", type=int, default=4000)
    p.add_argument("--probe_hz", type=int, default=25)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    return p.parse_args(argv)


# Phase-3 configs of run_paper_scale_synth (must match for determinism).
CONFIGS = {
    "faithful": dict(fused=False, dtype="float32", mode="VS"),
    "fused": dict(fused=True, dtype="float32", mode="VS"),
    # Healthy comparator: VS+ER, the baseline a GT-free channel must NOT flag.
    "vser": dict(fused=True, dtype="float32", mode="VS+ER"),
}
CSV_HEADER = "step,fcs,lr_cons,epe,mean_disp,mono,grad_norm,drift"


def flat_params(params: dict) -> np.ndarray:
    """The parameter tree's leaves in sorted-key order (jax.tree.leaves'
    order), raveled and concatenated."""
    def leaves(tree):
        if isinstance(tree, dict):
            for key in sorted(tree):
                yield from leaves(tree[key])
        else:
            yield np.asarray(tree).ravel()
    return np.concatenate(list(leaves(params)))


def probe_model(model_cfg, device):
    """The probe's own StereoModel for model_cfg, built without drawing from
    the global generators (their states are restored)."""
    from ..device import resolve_device
    from ..models import build_model

    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        return build_model(model_cfg, dev)


def probe(model, variables, left, right, gt, max_disp=192):
    """The study's probe of `variables` (JAX-layout, e.g. the driver's
    get_variables()) on one frame (left, right (1, H, W, 3), gt (1, H, W, 1)
    on the model's device), through `model`, the probe's own StereoModel,
    loaded with them and run in eval mode. Returns the floats (fcs,
    lr_cons, epe, mean_disp, mono, grad_norm):
      a batch-2 eval forward of (l, flip r) / (r, flip l) with the cost
      volume: the FCS of the left view's coarse cost, the left-right
      consistency of d_l with the flipped right-view disparity d_r, EPE and
      mean |d| of d_l;
      the Monodepth single loss of an eval forward of (l, r), and the global
      norm of its gradient over the stereo net's parameters."""
    from ..models import state_dicts_from_jax
    from ..ops import feature_contrast_mean, linear_warp, monodepth_single_loss

    net = model.stereo_net
    model.load_state_dicts(*state_dicts_from_jax(variables, net.k))
    model.eval()
    s, coarse = net.input_scale, net.input_scale + net.k
    flip = lambda x: torch.flip(x, dims=[2])  # noqa: E731
    with torch.no_grad():
        outs = model(torch.cat([left, flip(right)]), torch.cat([right, flip(left)]), side="l",
                     output_cost_volume=True)
        pred = outs[f"pred_disp_l/{s}"]
        d_l, d_r = pred[0:1], flip(pred[1:2])
        fcs = torch.mean(feature_contrast_mean(outs[f"cost_volume_l/{coarse}"][0:1]))
        # L-R cross-consistency: sample the right-view disparity at the
        # left-view matches; geometric agreement = |warped d_r - d_l|.
        warped, mask = linear_warp(d_r, d_l, max_disp=max_disp)
        m = mask.to(warped.dtype)
        lr_cons = torch.sum(torch.abs(warped - d_l) * m) / torch.clamp(torch.sum(m), min=1.0)
        epe = torch.mean(torch.abs(d_l - gt))
        mean_disp = torch.mean(torch.abs(d_l))

    params = list(model.parameters())
    o = model(left, right, side="l")
    mono, _ = monodepth_single_loss(left, right, o[f"pred_disp_l/{s}"], 1e-3, max_disp=max_disp)
    grads = torch.autograd.grad(mono, params, allow_unused=True)
    stereo = {id(p) for p in net.parameters()}
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for p, g in zip(params, grads)
                           if id(p) in stereo and g is not None))
    return tuple(float(x) for x in (fcs, lr_cons, epe, mean_disp, mono.detach(), gnorm))


def main(argv=None) -> int:
    a = parse_args(argv)
    os.makedirs(a.out, exist_ok=True)

    from ..data import StereoDataset
    from ..device import resolve_device
    from ..engine import AdaptConfig, DataConfig, ExperimentConfig, ModelConfig, OptimConfig
    from ..engine.checkpoint import load_variables
    from ..engine.stream_driver import adapt_streaming

    dev = resolve_device(a.device)
    train_root = os.path.join(a.work, "train_domain")
    novel_root = os.path.join(a.work, "novel_domain")
    weights = os.path.join(a.work, "logs", "pretrain", "models", "weights_final")
    with open(os.path.join(a.artifacts, "ood_threshold.json")) as f:
        threshold = json.load(f)["threshold"]
    print(f"[study] weights {weights}, threshold {threshold:.4f}", flush=True)
    variables = load_variables(weights)
    theta0 = flat_params(variables["params"])
    theta0_norm = float(np.linalg.norm(theta0))

    # Fixed probe frame: stream frame 0 + GT.
    probe_ds = StereoDataset(novel_root, "Synthetic", "synth", a.height, a.width, "train",
                             scales=[0], load_disp_left=True, load_disp_right=False)
    it = probe_ds[0]
    pl_, pr_, pgt = (torch.from_numpy(it[key][None]).to(dev)
                     for key in ("color_l/0", "color_r/0", "gt_disp_l/0"))

    for cname in a.configs:
        copts = CONFIGS[cname]
        model_cfg = ModelConfig(k=4, input_scale=0, compute_dtype=copts["dtype"],
                                fused_siamese=copts["fused"], s2d_refinement=copts["fused"])
        pmodel = probe_model(model_cfg, dev)
        rows = []

        def hook(step, get_vars):
            if step % a.probe_hz:
                return
            v = get_vars()
            out = list(probe(pmodel, v, pl_, pr_, pgt))
            drift = float(np.linalg.norm(flat_params(v["params"]) - theta0)) / theta0_norm
            rows.append([step] + out + [drift])
            if len(rows) % 20 == 1:
                print(f"[{cname}] step {step}: fcs={out[0]:.3f} "
                      f"lr_cons={out[1]:.3f} epe={out[2]:.2f} "
                      f"|d|={out[3]:.2f} mono={out[4]:.4f} "
                      f"gnorm={out[5]:.3f} drift={drift:.4f}", flush=True)

        cfg = ExperimentConfig(
            model_name=f"gtfree_{cname}", log_dir=os.path.join(a.work, "logs"),
            num_epochs=100, log_frequency=a.probe_hz, seed=123, log_images=False,
            model=model_cfg,
            optim=OptimConfig(learning_rate=5e-5, clip_grad_norm=True,
                              scheduler_step_size=10 ** 6),
            data=DataConfig(dataset_path=novel_root, dataset_name="Synthetic", split="synth",
                            height=a.height, width=a.width, batch_size=1, num_workers=4),
            adapt=AdaptConfig(
                adapt_mode=copts["mode"], num_steps=a.adapt_steps, eval_hz=1000,
                ovs_buffer_size=16, ovs_validate_hz=200, val_improve_retries=2,
                er_loss_weight=0.05, ood_threshold=threshold, skip_initial_eval=True,
                train_dataset_path=train_root, train_dataset_name="Synthetic",
                train_split="synth"),
        )
        t0 = time.perf_counter()
        r = adapt_streaming(cfg, variables=variables, engine="flat",
                            fused_er_forward=copts["fused"], device_cache=True,
                            probe_hook=hook, device=dev)
        dt = time.perf_counter() - t0
        out_csv = os.path.join(a.out, f"probes_{cname}.csv")
        np.savetxt(out_csv, np.asarray(rows), delimiter=",", fmt="%.6g", header=CSV_HEADER,
                   comments="")
        fm = r["final_metrics"]
        print(f"[{cname}] done in {dt:.0f}s: final adapt EPE "
              f"{fm.get('adapt', {}).get('EPE', float('nan')):.2f} train EPE "
              f"{fm.get('train', {}).get('EPE', float('nan')):.2f} "
              f"updates {r['gradient_updates']} -> {out_csv}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
