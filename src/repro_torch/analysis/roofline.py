"""Three-term roofline analysis against one NVIDIA H100 SXM.

    PYTHONPATH=src python -m repro_torch.analysis.roofline \
        [--dryrun experiments/dryrun] [--out experiments/roofline_h100.md]

The port of ``repro.analysis.roofline`` with the card's published figures
in place of the TPU's.  Per (arch × shape × mesh) record of a dry run (the
JAX package's record layout: ``cost`` per device, ``collectives``,
``memory``, ``n_chips``):

  compute_s    = FLOPs_per_device / PEAK_FLOPS          (989 TF/s dense bf16)
  memory_s     = bytes_per_device / HBM_BW              (3.35 TB/s)
  collective_s = collective_bytes_per_device / NVLINK_BW (450 GB/s a way)

MODEL_FLOPS is the analytic useful compute of a step (6·N_active·D for
training, 2·N for single-token decode, family-specific estimates
elsewhere), the same formulas as the JAX package's.  :func:`bound` and
:func:`kernel_roofline` give a kernel's least time and achieved share from
the bytes it must move and the operations it must do; ``chip_smoke.py``
computes every kernel bound with them.  The JAX package's ``VMEM_BYTES``
(the Pallas tile budget) has no counterpart: the CUDA kernels choose their
own launch shape.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional, Tuple

# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column; dense rates
# (without sparsity), at the 700 W maximum power limit.
#: bfloat16 tensor-core FLOP/s (1,979 TFLOP/s with sparsity, half dense)
PEAK_FLOPS = 989e12
#: float32 FLOP/s outside the tensor cores (the data sheet's "FP32" row)
FP32_FLOPS = 67e12
#: HBM3 bytes/s of the 80 GB part
HBM_BW = 3.35e12
#: NVLink bytes/s each way (the data sheet's 900 GB/s is both ways summed)
NVLINK_BW = 450e9


def bound(bytes_moved: float, flops: float = 0.0) -> Tuple[float, str]:
    """Least seconds the card could take: the larger of the bytes over
    :data:`HBM_BW` and the float32 operations over :data:`FP32_FLOPS` (the
    port's kernels compute in float32), with which of the two bounds it.

    >>> bound(3.35e9, 1e9)
    (0.001, 'bytes')
    """
    memory_s = bytes_moved / HBM_BW
    compute_s = flops / FP32_FLOPS
    if memory_s >= compute_s:
        return memory_s, "bytes"
    return compute_s, "operations"


def kernel_roofline(bytes_moved: float, seconds: float,
                    flops: float = 0.0) -> Dict:
    """Achieved-vs-peak terms for one measured kernel invocation.

    Takes the *measured* time plus the analytic bytes the kernel must move
    (each input read once, each output written once) and the operations
    it must do, and reports achieved bandwidth against :data:`HBM_BW` and
    achieved FLOP/s against :data:`FP32_FLOPS`, with the :func:`bound` and
    its share.
    """
    achieved_bw = bytes_moved / seconds if seconds > 0 else 0.0
    achieved_flops = flops / seconds if seconds > 0 else 0.0
    bound_s, bound_by = bound(bytes_moved, flops)
    return {
        "bytes_moved": bytes_moved,
        "seconds": seconds,
        "achieved_bytes_per_s": achieved_bw,
        "peak_bytes_per_s": HBM_BW,
        "bw_fraction": achieved_bw / HBM_BW,
        "achieved_flops_per_s": achieved_flops,
        "flops_fraction": achieved_flops / FP32_FLOPS,
        "bound_s": bound_s,
        "bound_by": bound_by,
        "bound_fraction": bound_s / seconds if seconds > 0 else 0.0,
    }


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS per family (global, whole step)
# ---------------------------------------------------------------------------


def _lm_model_flops(arch_name: str, shape: Dict) -> Optional[float]:
    from repro_torch.launch.api import get_arch

    cfg = get_arch(arch_name).make_config(False)
    n_mm = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    if cfg.tie_embeddings:
        n_mm += cfg.vocab_size * cfg.d_model  # head matmul still happens
    b = shape.get("global_batch")
    s = shape.get("seq_len")
    l, h, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
    kind = shape["kind"]
    if kind == "train":
        tokens = b * s
        return 6.0 * n_mm * tokens + 12.0 * l * b * s * s * h * hd
    if kind == "prefill":
        tokens = b * s
        return 2.0 * n_mm * tokens + 4.0 * l * b * s * s * h * hd
    if kind == "decode":
        return 2.0 * n_mm * b + 4.0 * l * b * s * h * hd
    return None


def _gnn_model_flops(shape: Dict) -> float:
    from repro_torch.launch.api import get_arch

    cfg = get_arch("gatedgcn").make_config(False)
    d = cfg.d_hidden
    n, e = shape["n_nodes"], shape["n_edges"]
    d_in = shape.get("d_feat", cfg.d_in)
    nc = shape.get("n_classes", cfg.n_classes)
    per_layer = 4.0 * n * d * d + 6.0 * e * d * d
    fwd = cfg.n_layers * per_layer + 2.0 * n * d_in * d + 2.0 * n * d * nc
    return 3.0 * fwd  # train step ≈ fwd + 2×fwd backward


def _recsys_model_flops(arch_name: str, shape: Dict) -> Optional[float]:
    from repro_torch.launch.api import get_arch

    cfg = get_arch(arch_name).make_config(False)
    kind = shape["kind"]
    b = shape.get("batch", 1)

    def fwd_per_example() -> float:
        if arch_name == "xdeepfm":
            dmodel, f = cfg.table.dim, cfg.table.n_fields
            flops, h_prev = 0.0, f
            for h in cfg.cin_layers:
                flops += 2.0 * dmodel * h_prev * f * h
                h_prev = h
            dims = (f * dmodel,) + tuple(cfg.mlp_dims) + (1,)
            flops += sum(2.0 * a * bb for a, bb in zip(dims[:-1], dims[1:]))
            return flops
        if arch_name == "autoint":
            f = cfg.table.n_fields
            da, nh = cfg.d_attn, cfg.n_attn_heads
            d_in = cfg.table.dim
            flops = 0.0
            for _ in range(cfg.n_attn_layers):
                flops += 4.0 * 2.0 * f * d_in * da * nh  # q,k,v,res proj
                flops += 2.0 * 2.0 * f * f * da * nh  # scores + weighted sum
                d_in = da * nh
            return flops + 2.0 * f * d_in
        if arch_name == "sasrec":
            d, s = cfg.embed_dim, cfg.seq_len
            per_block = 2.0 * s * d * 3 * d + 2.0 * s * d * d * 2 + \
                4.0 * s * s * d
            return cfg.n_blocks * per_block + 4.0 * s * d  # + BCE dots
        if arch_name == "mind":
            d, t, k = cfg.table.dim, cfg.hist_len, cfg.n_interests
            route = cfg.capsule_iters * (2.0 * k * t * d * 2)
            return 2.0 * t * d * d + route + 2.0 * d * 4 * d * 2
        return 0.0

    per_ex = fwd_per_example()
    if kind == "train":
        return 3.0 * b * per_ex
    if kind == "serve":
        slate = shape.get("slate", 0)
        if slate and arch_name in ("sasrec", "mind"):
            d = cfg.embed_dim if arch_name == "sasrec" else cfg.table.dim
            return b * (per_ex + 2.0 * slate * d)
        return b * per_ex
    if kind == "retrieval":
        nc = shape["n_candidates"]
        if arch_name in ("sasrec", "mind"):
            d = cfg.embed_dim if arch_name == "sasrec" else cfg.table.dim
            k = getattr(cfg, "n_interests", 1) or 1
            return per_ex + 2.0 * nc * d * k
        return nc * per_ex  # CTR: full forward per candidate
    return None


def _eval_model_flops(shape: Dict) -> float:
    # sort (~D log2 D compares) + ~8 cumulative passes over [Q, D]
    import math

    q, d = shape["n_queries"], shape["n_docs"]
    return q * d * (math.log2(max(d, 2)) + 8.0)


def model_flops(rec: Dict) -> Optional[float]:
    from repro_torch.launch.api import get_arch

    arch = rec["arch"]
    fam = rec["family"]
    spec = get_arch(arch).shapes[rec["shape"]]
    shape = dict(spec.meta)
    shape["kind"] = spec.kind
    if fam == "lm":
        return _lm_model_flops(arch, shape)
    if fam == "gnn":
        return _gnn_model_flops(shape)
    if fam == "recsys":
        return _recsys_model_flops(arch, shape)
    if fam == "eval":
        return _eval_model_flops(shape)
    return None


# ---------------------------------------------------------------------------
# Per-record analysis
# ---------------------------------------------------------------------------


def analyze(rec: Dict, probe: Optional[Dict] = None) -> Optional[Dict]:
    if rec["status"] != "ok":
        return None
    chips = rec["n_chips"]
    flops_dev = rec["cost"].get("flops", 0.0)
    bytes_dev = rec["cost"].get("bytes accessed", 0.0)
    coll_dev = rec["collectives"]["total"]
    scan_corrected = False
    if probe and probe.get("status") == "ok":
        # XLA counts the scan body once; correct the full compile's totals
        # with (L−1) extra copies of the true per-layer cost measured by the
        # unrolled L=1/L=2 probe (the JAX package's
        # launch/dryrun.py::run_scan_probe writes these records).
        t = probe["trips"]
        body = probe["body"]
        flops_dev += (t - 1) * max(body["flops"], 0.0)
        bytes_dev += (t - 1) * max(body["bytes"], 0.0)
        coll_dev += (t - 1) * max(body["collective"], 0.0)
        scan_corrected = True
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    mf = model_flops(rec)
    hlo_global = flops_dev * chips
    ratio = (mf / hlo_global) if (mf and hlo_global > 0) else None
    # roofline fraction: useful model FLOP/s at the bound vs peak
    frac = None
    if mf is not None and step_s > 0:
        frac = (mf / chips / step_s) / PEAK_FLOPS
    suggestion = {
        "compute": "compute-bound: raise tensor-core utilization (bf16 "
                   "everywhere, fuse small ops, cut remat recompute)",
        "memory": "memory-bound: raise arithmetic intensity (fuse passes, "
                  "larger tiles in shared memory, avoid fp32 copies)",
        "collective": "collective-bound: reshard to cut cross-device bytes "
                      "(overlap with compute, compress, change TP split)",
    }[dominant]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips, "scan_corrected": scan_corrected,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": mf, "hlo_flops_global": hlo_global,
        "model_over_hlo": ratio, "roofline_fraction": frac,
        "peak_bytes_per_dev": rec["memory"].get("peak_bytes") or
        (rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]),
        "suggestion": suggestion,
    }


def fmt_s(x: Optional[float]) -> str:
    if x is None:
        return "–"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}µs"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.roofline",
        description="Roofline terms of dry-run records against one H100.")
    ap.add_argument("--dryrun", default="experiments/dryrun")
    ap.add_argument("--out", default="experiments/roofline_h100.md")
    ap.add_argument("--mesh", default="single",
                    help="mesh for the main table (spec: single-pod)")
    args = ap.parse_args(argv)

    probes = {}
    for path in glob.glob(os.path.join(args.dryrun, "*__probe.json")):
        with open(path) as fh:
            p = json.load(fh)
        probes[(p["arch"], p["shape"], p["mesh"])] = p

    rows, skips = [], []
    for path in sorted(glob.glob(os.path.join(args.dryrun, "*.json"))):
        if path.endswith("__probe.json"):
            continue
        with open(path) as fh:
            rec = json.load(fh)
        if rec["status"] == "skipped":
            skips.append(rec)
            continue
        a = analyze(rec, probes.get((rec["arch"], rec["shape"],
                                     rec["mesh"])))
        if a:
            rows.append(a)

    lines = [
        "| arch | shape | mesh | compute | memory | collective | dominant |"
        " MODEL/HLO | roofline frac | HBM/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["mesh"] != args.mesh:
            continue
        ratio = f"{r['model_over_hlo']:.2f}" if r["model_over_hlo"] else "–"
        frac = (f"{100*r['roofline_fraction']:.1f}%"
                if r["roofline_fraction"] is not None else "–")
        hbm = f"{r['peak_bytes_per_dev']/2**30:.2f}GiB"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
            f" {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} |"
            f" {fmt_s(r['collective_s'])} | **{r['dominant']}** |"
            f" {ratio} | {frac} | {hbm} |")
    lines.append("")
    lines.append("Skipped cells: " + "; ".join(
        sorted({f"{s['arch']}×{s['shape']} ({s['skip_reason'][:40]}…)"
                for s in skips})) if skips else "No skips.")
    out = "\n".join(lines)
    print(out)
    with open(args.out, "w") as fh:
        fh.write(out + "\n")
    with open(args.out.replace(".md", ".json"), "w") as fh:
        json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
