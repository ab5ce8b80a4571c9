"""How far the attention half's kernels move one XTag train step from
their plain versions, launch by launch, on one NVIDIA GPU.

    python3 probe_attn_numerics.py

The attention half's forward (``fused_attn_half``) and backward
(``fused_attn_half_bwd``) kernels run inside one autograd Function of
``xtagclip_tpu_torch.ops.fused_attn_block``. For each of chip_smoke.py's
two train paths (ViT-B-32; the cls-free GAP ViT-B-16 at 256 px), from
chip_smoke's weights, batch and dropout seed, one train step is run:

- ``kernels``: every kernel on;
- ``plain_inside``: the same Function, each launch of both kernels
  through its plain version (``reference_attn_half`` /
  ``reference_attn_half_bwd``: the kernels' rounding points in fp32
  PyTorch); ``fwd_plain`` / ``bwd_plain``: only the forward's / only the
  backward's launches so;
- ``plain``: every kernel off (autograd through the plain halves, what
  chip_smoke.py's train-path phase compares against), and ``plain_up`` /
  ``plain_down`` on images one bf16 step up / down: each gradient's noise
  floor, the larger of the two distances to ``plain``;
- one launch at a time: ``kernels`` with launch i of the forward (or of
  the backward) through its plain version.

Each run prints its loss and, against ``plain`` and against
``plain_inside``: the lowest gradient cosine, and the largest ratio of a
gradient's distance to its noise floor, with the parameter. Then every
launch of the ``kernels`` step is run again on its captured inputs,
kernel against plain version: per output, the share of elements whose
bits differ and the most bf16 ULPs any element differs by (at the
element's scale, no lower than max|ref| / 8), or for an fp32 output its
largest difference over max|ref|. One JSON line per path and table; the
last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import sys

import torch

import chip_smoke as cs
from xtagclip_tpu_torch.factory import create_model
from xtagclip_tpu_torch.models.layers import set_use_kernels
from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.train.loop import make_train_step

KERNEL_FWD = fab._attn_half_fwd
KERNEL_BWD = fab.fused_attn_half_bwd
BWD_OUTPUTS = ("dx", "dq", "dk", "dv", "dwout", "dbout", "dls", "dlb")


class Route:
    """Stands in for the two kernel wrappers inside the autograd Function:
    launch i of the forward (backward) runs the plain version when i is in
    ``fwd_plain`` (``bwd_plain``), and with ``capture`` set every launch's
    inputs are kept."""

    def __init__(self):
        self.fwd_plain, self.bwd_plain = set(), set()
        self.n_fwd = self.n_bwd = 0
        self.capture = None

    def reset(self, fwd_plain=(), bwd_plain=(), capture=False):
        self.fwd_plain, self.bwd_plain = set(fwd_plain), set(bwd_plain)
        self.n_fwd = self.n_bwd = 0
        self.capture = {"fwd": [], "bwd": []} if capture else None

    def _keep(self, kind, args):
        if self.capture is not None:
            self.capture[kind].append(tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))

    def fwd(self, *args):
        i, self.n_fwd = self.n_fwd, self.n_fwd + 1
        self._keep("fwd", args)
        plain = i in self.fwd_plain
        return (fab.reference_attn_half if plain else KERNEL_FWD)(*args)

    def bwd(self, *args):
        i, self.n_bwd = self.n_bwd, self.n_bwd + 1
        self._keep("bwd", args)
        plain = i in self.bwd_plain
        return (fab.reference_attn_half_bwd if plain else KERNEL_BWD)(*args)


def _bf16_stats(out, ref):
    out, ref = out.float(), ref.float()
    scale = ref.abs().clamp_min(ref.abs().max() / 8)
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    return {"share_differing": (out != ref).float().mean().item(),
            "max_ulps": ((out - ref).abs() / ulp).max().item()}


def _fp32_stats(out, ref):
    return {"max_err_over_max_ref":
            ((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()}


def _worst(stats):
    """Per output, the worst value of each statistic over the launches."""
    keys = stats[0].keys()
    return {k: {s: max(st[k][s] for st in stats) for s in stats[0][k]}
            for k in keys}


def launch_table(captured):
    """Every captured launch again, kernel against plain version."""
    fwd = []
    for args in captured["fwd"]:
        with torch.no_grad():
            fwd.append({"out": _bf16_stats(KERNEL_FWD(*args),
                                           fab.reference_attn_half(*args))})
    bwd = []
    for args in captured["bwd"]:
        d = args[0].shape[-1]
        with torch.no_grad():
            outs = [list(KERNEL_BWD(*args)),
                    list(fab.reference_attn_half_bwd(*args))]
        for o in outs:  # (dx, dq, dk, dv, dwout, dbout, dls, dlb)
            o[1:2] = list(o[1].split(d, -1))
        bwd.append({name: (_bf16_stats if k < 4 else _fp32_stats)(a, b)
                    for k, (name, a, b) in enumerate(zip(BWD_OUTPUTS, *outs))})
    return {"fwd_launches": len(fwd), "bwd_launches": len(bwd),
            "fwd_worst": _worst(fwd), "bwd_worst": _worst(bwd),
            "bwd_by_launch": bwd}


def probe_path(card, ptable, path, route):
    kernels = create_model(path["model"], use_tagging=True, use_fusion=True,
                           precision="bf16", init_seed=1, **path["kwargs"])
    plain = copy.deepcopy(kernels)
    set_use_kernels(plain, False)
    host = cs._train_batches(ptable, path["image"])[0]
    batch = cs._device_batch(host, ("additional", "texts"))
    p_batch = cs._device_batch(host, ("additional", "texts"), plain=True)
    start = copy.deepcopy(plain.state_dict())
    step = make_train_step({})

    def run(model, b, **how):
        route.reset(**how)
        model.load_state_dict(start)
        state = cs._new_train_state(model)
        gen = torch.Generator(device="cuda").manual_seed(1)
        _, m = step(state, b, gen)
        torch.cuda.synchronize()
        return m["loss"].item(), {n: p.grad.clone()
                                  for n, p in model.named_parameters()
                                  if p.grad is not None}

    def dist(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    p_loss, gp = run(plain, p_batch)
    names = [n for n in gp if gp[n].abs().max().item() > 0
             and not any(z in n for z in cs.ZERO_GRAD_PARAMS)]
    floor = {n: 0.0 for n in names}
    losses = {"plain": p_loss}
    for name, steps in (("plain_up", 1), ("plain_down", -1)):
        loss, g = run(plain, dict(p_batch, images=cs._bf16_ulp_shift(
            p_batch["images"], steps)))
        losses[name] = loss
        for n in names:
            floor[n] = max(floor[n], dist(g[n], gp[n]))
        del g
    n_fwd = path["per_step"]["fused_attn_half"]
    n_bwd = path["per_step"]["fused_attn_half_bwd"]
    inside_loss, g_inside = run(kernels, batch, fwd_plain=range(n_fwd),
                                bwd_plain=range(n_bwd))

    def against(g, ref):
        ratio = {n: dist(g[n], ref[n]) / floor[n] for n in names}
        cos = {n: cs._cos(g[n], ref[n]) for n in names}
        worst = max(ratio, key=ratio.get)
        low = min(cos, key=cos.get)
        return {"max_dist_over_noise": ratio[worst], "at": worst,
                "grad_cos_min": cos[low], "cos_min_at": low}

    runs = {}

    def record(label, loss, g):
        runs[label] = {"loss": loss, "vs_plain": against(g, gp),
                       "vs_plain_inside": against(g, g_inside)}

    record("plain_inside", inside_loss, g_inside)
    loss, g = run(kernels, batch, capture=True)
    captured = route.capture
    record("kernels", loss, g)
    del g
    record("fwd_plain", *run(kernels, batch, fwd_plain=range(n_fwd)))
    record("bwd_plain", *run(kernels, batch, bwd_plain=range(n_bwd)))
    one = {}
    for kind, n in (("fwd", n_fwd), ("bwd", n_bwd)):
        for i in range(n):
            loss, g = run(kernels, batch, **{f"{kind}_plain": [i]})
            one[f"{kind}{i}"] = {"loss": loss,
                                 "vs_plain": against(g, gp)["max_dist_over_noise"],
                                 "vs_plain_inside":
                                     against(g, g_inside)["max_dist_over_noise"]}
            del g
    cs._emit({"probe": path["prefix"] + "train_step_runs", "card": card,
              "model": path["label"], "losses": losses, "runs": runs})
    cs._emit({"probe": path["prefix"] + "one_launch_plain", "card": card,
              "model": path["label"],
              "launch_order": "forward launches in the step's order, backward "
                              "launches in autograd's (last block first)",
              "runs": one})
    cs._emit({"probe": path["prefix"] + "launches", "card": card,
              "model": path["label"], **launch_table(captured)})


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs._card()
    route = Route()

    def bwd(*args):  # the kernel wrapper counts its launches on this name
        return route.bwd(*args)

    bwd.launches = 0
    fab._attn_half_fwd, fab.fused_attn_half_bwd = route.fwd, bwd
    ptable = cs._scar_prompt_table()
    paths = cs._paths()
    for key in ("b32", "gap"):
        probe_path(card, ptable, paths[key], route)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
