"""Rank programs that hold a mesh layout to the single-rank step.

``run(spec)`` is started on every rank by ``parallel/launch.launch`` (the
CPU tests and ``chip_smoke.py`` both use it): for each case of
``spec["cases"]`` it builds the mesh of a ``ParallelConfig``, takes this
rank's slices of the same whole parameters, and runs ``steps`` steps of
the real train step: their global losses, the first two steps' gradients
as the step hands them to the optimizer (gathered whole), and the
parameters after the last step (gathered whole).  Rank 0 returns the
whole trees; every rank returns its losses, times and kernel launch
counts.

``run_trainer(spec)`` does the same through ``CSMTrainer`` /
``CSMLoRATrainer(parallel=...)``: ``train`` over the given batches,
checkpoints, and a resume from the first checkpoint that must continue
bit for bit.

spec: {"device": "cpu" | "cuda", "args": ModelArgs, "params": path of a
``torch.save``d whole tree, "batches": [global Batch of CPU tensors],
"scores": [global (B·T,) frame scores] or None, "cases": [{"name",
"parallel": ParallelConfig kwargs, "steps", "lr", "dtype": "f32" | "bf16",
"remat", "ratio", "lora": None or LoRAConfig kwargs, "pp_model_parallel":
a model axis inside the pipeline's stages, "lora_params": path of a saved
adapter tree (else drawn from seed 42), "quant": None | "int8" | "int4"
(the frozen base of a LoRA case), "compare": False (no reference check),
"host_results": False (whole trees kept on the device)}], "reference": a
case run first on rank 0 alone as the single-process step (no mesh, no
layouts), against which every comparing case is held (``compare``;
"tolerances"), "ring": [run_ring's cases], "trainers":
[run_trainer's keys with a "name"], "calls": [(name, "module:function",
argv)]}.
"""

from __future__ import annotations

import time

import torch

from csm_torch.parallel.mesh import ParallelConfig, mesh_kwargs

_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _launch_counts():
    from csm_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.launches, "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches}


def _reset_counts():
    from csm_torch.ops import flash_attention as fa

    fa.launches = fa.dq_launches = fa.dkv_launches = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _whole_params(c: dict, args, device, dt):
    """The case's whole parameters: loaded from ``c["params"]`` (a path) or
    drawn from ``{"seed": s}`` on ``device`` (the same on every rank)."""
    from csm_torch.utils.params import random_csm_params

    src = c["params"]
    if isinstance(src, dict):
        whole = random_csm_params(args, seed=src["seed"], device=device)
    else:
        whole = torch.load(src, map_location="cpu", weights_only=True)
    return {k: ({n: t.to(device, dt) for n, t in v.items()} if isinstance(v, dict)
                else v.to(device, dt)) for k, v in whole.items()}


def run_case(case: dict, spec: dict, device, single: bool = False) -> dict:
    """One case (its keys over the spec's); ``single``: the single-process
    step, with no mesh and no layouts (the reference)."""
    from csm_torch.parallel import sharding
    from csm_torch.parallel.pipeline import lora_pp_layouts
    from csm_torch.training import lora as lora_mod
    from csm_torch.training.losses import Batch
    from csm_torch.training.optimizer import (init_train_state, make_lora_optimizer,
                                              make_optimizer, named_leaves)
    from csm_torch.training.train_step import make_lora_train_step, make_train_step

    t_case = time.perf_counter()
    c = dict(spec, **case)
    args = c["args"]
    par = ParallelConfig(**c["parallel"])
    if single:  # the single-process step: no mesh, no layouts
        mesh = None
    elif case.get("pp_model_parallel", 1) > 1:  # PP+TP: the pipeline mesh with a model axis
        from csm_torch.parallel.pipeline import make_pp_mesh

        mesh = make_pp_mesh(pipeline_parallel=par.pipeline_parallel,
                            model_parallel=case["pp_model_parallel"])
    else:
        mesh = par.build_mesh()
    mkw = {} if single else mesh_kwargs(par, mesh)
    dt = _DT[c.get("dtype", "f32")]  # compute
    lcfg = c.get("lora")
    pdt = _DT[c.get("param_dtype", "f32" if lcfg is None else c.get("dtype", "f32"))]
    whole = _whole_params(c, args, device, pdt)
    if case.get("quant") == "int8":  # a frozen base held quantized (QLoRA)
        from csm_torch.utils import quantize as qz

        whole = qz.quantize_csm_params(whole)
    elif case.get("quant") == "int4":
        from csm_torch.utils import quantize as qz

        whole = qz.quantize_csm_params_int4(whole)
    layouts, local = None, whole
    if not single:
        layouts = sharding.param_layouts(whole, args, mesh)
        local = sharding.shard_tree(whole, layouts, mesh)
    del whole
    batches = [Batch(*(t.to(device) for t in b)) for b in c["batches"]]
    scores = None if c.get("scores") is None else [t.to(device) for t in c["scores"]]
    steps = c.get("steps", 2)
    common = dict(semantic_weight=100.0, acoustic_weight=1.0,
                  amortization_ratio=c.get("ratio", 16), compute_dtype=dt,
                  remat=c.get("remat", False))
    gen = torch.Generator(device=device).manual_seed(0)
    if lcfg is None:
        tx = make_optimizer(local, learning_rate=c.get("lr", 1e-3))
        state = init_train_state(local, tx)
        step = make_train_step(args, tx, layouts=layouts, **common, **mkw)
        trained, t_layouts = local, layouts
    else:
        cfg = lora_mod.LoRAConfig(**lcfg)
        if c.get("lora_params"):
            lw = torch.load(c["lora_params"], map_location=device, weights_only=True)
        else:
            lw = lora_mod.init_lora_params(torch.Generator(device=device).manual_seed(42), args,
                                           cfg, device=device)
        t_layouts, trained = None, lw
        if not single:
            t_layouts = (lora_pp_layouts(lw, mesh) if par.pipeline_parallel > 1
                         else {k: {n: {ab: (None,) * t.dim() for ab, t in ad.items()}
                                   for n, ad in v.items()} for k, v in lw.items()})
            trained = sharding.shard_tree(lw, t_layouts, mesh)
        tx = make_lora_optimizer(learning_rate=c.get("lr", 1e-3))
        state = init_train_state(trained, tx)
        step0 = make_lora_train_step(args, tx, cfg.scaling, lora_dropout=cfg.dropout,
                                     base_layouts=layouts, layouts=t_layouts,
                                     **{k: v for k, v in common.items()},
                                     **mkw)
        step = lambda st, g, b, frame_scores=None: step0(st, local, g, b, frame_scores)  # noqa: E731
    rank = 0 if single else mesh.rank
    out = {"losses": [], "ms": [], "rank": rank, "shape": {} if single else dict(mesh.shape)}
    taken = []  # the first two steps' gradients
    flat_lay = [None] * len(named_leaves(trained))
    if not single:
        flat_lay = [sp for _, sp in sharding.flat_layouts(trained, t_layouts)]
    # rank 0 keeps every gradient, the others only their slices of split leaves
    keep = [rank == 0 or any(mesh.axis_size(a) > 1 for a in sharding._axes(sp))
            for sp in flat_lay]
    if c.get("grads", True):  # of the global loss, as given to the optimizer, before
        real_update = tx.update  # its clip scales them in place

        def update(params, grads, state):
            if len(taken) < 2:
                taken.append([g.detach().clone() if k else None for g, k in zip(grads, keep)])
            return real_update(params, grads, state)

        tx.update = update
    _sync(device)
    _reset_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, gen, batches[i % len(batches)],
                        frame_scores=None if scores is None else scores[i % len(scores)])
        out["losses"].append(float(m["loss"]))
        _sync(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    out["launches"] = _launch_counts()
    host = c.get("host_results", True)
    paths = [p for p, _ in named_leaves(trained)]
    for key, grads in zip(("grads", "grads2"), taken):  # gathered whole
        if single:
            whole_g = dict(zip(paths, grads))
        else:
            with torch.no_grad():
                whole_g = {p: sharding._gather_whole(g, sp, mesh)
                           for p, g, sp in zip(paths, grads, flat_lay) if g is not None}
        if rank == 0:
            out[key] = {p: g.cpu() if host else g for p, g in whole_g.items()}
        del grads[:], whole_g
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if c.get("params_out", True):
        whole_p = (state.params if single
                   else sharding.unshard_tree(state.params, t_layouts, mesh))
        if rank == 0:
            out["params"] = {p: (t.detach().cpu() if host else t.detach().clone())
                             for p, t in named_leaves(whole_p)}
    out["wall_s"] = time.perf_counter() - t_case
    print(f"case {c['name']} {out['shape']}: {out['wall_s']:.1f} s, steps {out['ms']} ms",
          flush=True)
    return out


def run(spec: dict) -> dict:
    """Every case of ``spec`` on this rank (see the module note)."""
    from csm_torch.parallel.distributed import rank_device

    device = rank_device(spec.get("device", "cpu"))
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = spec.get("tf32", False)
        torch.backends.cudnn.allow_tf32 = spec.get("tf32", False)
    import torch.distributed as dist

    results, ref = {}, None
    if spec.get("reference") is not None:  # rank 0 alone, before the meshes
        if dist.get_rank() == 0:
            ref = run_case(spec["reference"], spec, device, single=True)
            _fresh(device)
        dist.barrier()
    for case in spec.get("cases", ()):
        if not case.get("compare", True) and ref is not None:  # its memory off the figures
            ref = None
            _fresh(device)
        out = results[case["name"]] = run_case(case, spec, device)
        if ref is not None and "grads" in out and case.get("compare", True):
            out["vs_reference"] = compare(out, ref, spec.get("tolerances", {}))
            for k in ("grads", "grads2", "params"):
                out.pop(k, None)
        _fresh(device)
    for rc in spec.get("ring", ()):
        results["ring:" + rc["name"]] = run_ring(rc, device)
    for t in spec.get("trainers", ()):
        results["trainer:" + t["name"]] = run_trainer(dict(spec, **t))
    for name, target, argv in spec.get("calls", ()):  # entry points, e.g. a CLI's main
        import importlib

        mod, fn = target.split(":")
        results["call:" + name] = getattr(importlib.import_module(mod), fn)(list(argv))
    return results


def _fresh(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def compare(out: dict, ref: dict, tol: dict) -> dict:
    """A two-step case against the reference: the losses' largest relative
    difference, each first-step gradient's largest share of its tolerance
    (atol + rtol·|ref|) and its largest difference, and the parameters
    after two AdamW steps, each element within what the measured gradient
    noise lets its updates move.

    With ``e`` the largest difference of either step's gradients and g1,
    g2 the reference's: Adam's first update lr·g1/(|g1|+eps) moves by at
    most lr·min(2, e/|g1|) (2·lr: a sign flip), and its second, a function
    of (g1, g2) of degree 0 whose gradient is at most 1.42/|(g1, g2)| in
    the L1 norm, by at most lr·min(2, 2·e/|(g1, g2)|); a step whose
    gradient is exactly 0 on both sides moves nothing.  An element's bound
    is the larger of ``param_atol`` and that sum: the strict elements are
    held to ``param_atol`` itself, the free ones (bound 2·lr or more) only
    to the most noise can move them.  ``ok`` when all are within ``tol``
    ("loss_rtol", "grad_atol", "grad_rtol", "param_atol", "lr": the
    largest learning rate of any component)."""
    lr_tol, ga, gr, pa, lr = (tol[k] for k in ("loss_rtol", "grad_atol", "grad_rtol",
                                               "param_atol", "lr"))
    loss = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], ref["losses"]))
    g_used = g_err = 0.0
    for key in ("grads", "grads2"):
        for path, g in out[key].items():
            r = ref[key][path].float()
            err = (g.float() - r).abs()
            g_err = max(g_err, err.max().item())
            if key == "grads":
                g_used = max(g_used, (err / (ga + gr * r.abs())).max().item())
    p_used = p_strict = p_free = 0.0
    n_strict = n_free = n_all = 0
    for path, p in out["params"].items():
        err = (p.float() - ref["params"][path].float()).abs()
        g1, g2 = ref["grads"][path].float(), ref["grads2"][path].float()
        still1 = (g1 == 0) & (out["grads"][path] == 0)
        still = still1 & (g2 == 0) & (out["grads2"][path] == 0)
        e1 = torch.where(still1, 0.0, (g_err / g1.abs()).nan_to_num(2.0).clamp(max=2.0))
        e2 = torch.where(still, 0.0, (2 * g_err / torch.hypot(g1, g2)).nan_to_num(2.0)
                         .clamp(max=2.0))
        bound = (lr * (e1 + e2)).clamp(min=pa)
        p_used = max(p_used, (err / bound).max().item())
        strict, free = bound <= pa, e1 + e2 >= 2.0
        if strict.any():
            p_strict = max(p_strict, err[strict].max().item())
        if free.any():
            p_free = max(p_free, err[free].max().item())
        n_strict, n_free, n_all = (n_strict + int(strict.sum()), n_free + int(free.sum()),
                                   n_all + err.numel())
    ok = loss <= lr_tol and g_used <= 1 and p_used <= 1
    return {"loss_rel": loss, "grad_share": g_used, "grad_max_abs": g_err, "param_share": p_used,
            "param_strict_max_abs": p_strict, "strict_elements": n_strict,
            "param_free_max_abs": p_free, "free_elements": n_free, "elements": n_all,
            "ok": bool(ok), "tolerances": [lr_tol, ga, gr, pa, lr]}


def run_ring(rc: dict, device) -> dict:
    """``sharded_ring_attention`` on whole (B, S, ·) inputs over a (data,
    seq) mesh of ``rc["seq"]`` ranks in ``rc["layout"]``, and its gradients
    for the cotangent ``rc["g"]``: (rank 0) the output, dq, dk, dv; the
    flash launch counts of the forward and backward."""
    from csm_torch.parallel.ring_attention import make_sp_mesh, sharded_ring_attention

    mesh = make_sp_mesh(seq_parallel=rc["seq"])
    q, k, v = (rc[n].to(device).requires_grad_() for n in ("q", "k", "v"))
    _reset_counts()
    out = sharded_ring_attention(mesh, q, k, v, rc["q_pos"].to(device), rc["kv_pos"].to(device),
                                 layout=rc["layout"])
    (out.float() * rc["g"].to(device)).sum().backward()
    import torch.distributed as dist

    from csm_torch.parallel.distributed import all_reduce_

    for t in (q, k, v):  # each rank holds the gradient of its own rows and positions
        all_reduce_(t.grad, dist.group.WORLD)
    _sync(device)
    res = {"launches": _launch_counts()}
    if mesh.rank == 0:
        res.update(out=out.detach().cpu(), dq=q.grad.cpu(), dk=k.grad.cpu(), dv=v.grad.cpu())
    return res


def run_trainer(spec: dict) -> dict:
    """``CSMTrainer`` (or ``CSMLoRATrainer`` with ``spec["lora"]``) with
    ``parallel=ParallelConfig(**spec["parallel"])``: ``train`` over
    ``spec["batches"]`` for ``spec["epochs"]`` epochs (its checkpoints
    written), then the same trainer trained on in memory, and a second
    trainer resumed from the first one's checkpoint of that point (``first``) trained the
    same way.  Returns the losses, the mesh, and (rank 0) the parameters
    after the first run and after both continuations, gathered whole."""
    import copy
    import os

    from csm_torch.parallel.distributed import rank_device
    from csm_torch.training.trainer import CSMLoRATrainer, CSMTrainer

    device = rank_device(spec.get("device", "cpu"))
    par = ParallelConfig(**spec["parallel"])
    whole = torch.load(spec["params"], map_location="cpu", weights_only=True)
    lora = spec.get("lora")
    cls = CSMTrainer if lora is None else CSMLoRATrainer

    def make(out_dir):
        return cls(output_dir=out_dir, args=spec["args"], params=copy.deepcopy(whole),
                   learning_rate=spec.get("lr", 1e-3), compute_dtype=torch.float32, remat=False,
                   parallel=par, device=device, **(lora or {}))

    def train(tr):
        return tr.train(list(spec["batches"]), batch_size=spec["batch_size"],
                        epochs=spec["epochs"], save_every=10_000, val_every=10_000)

    out = {}
    tr = make(spec["out_dir"])
    out["loss"] = train(tr)
    out["mesh"] = dict(tr.mesh.shape)
    out["first"] = _copy(tr.gathered_state_params())  # training goes on in place
    tr.save_checkpoint("first")
    out["loss_continued"] = train(tr)
    out["continued"] = _copy(tr.gathered_state_params())
    tr2 = make(spec["out_dir"] + "_resumed")
    tr2.prepare_optimizer()
    tr2.load_checkpoint(os.path.join(spec["out_dir"], "checkpoints", "first"))
    out["step_resumed"] = tr2.global_step
    out["loss_resumed"] = train(tr2)
    out["resumed"] = _copy(tr2.gathered_state_params())
    if tr.mesh.rank != 0:
        for k in ("first", "continued", "resumed"):
            out.pop(k)
    return out


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.detach().cpu().clone()
            for k, v in tree.items()}
