"""Rank-side functions of the distributed tests (`test_torch_parallel.py`,
`test_torch_dp_train.py`, `test_torch_cuda.py`). Not a test module: each
function runs in every rank of a world that `parallel.launch.run_world`
spawns, and a spawned rank imports the module of its function, so this
module imports only numpy, torch and the port, never JAX or the JAX
package. The parent computes every reference figure and passes numpy
arrays in."""
import time

import numpy as np
import torch
import torch.distributed as dist

from pctpu_torch import parallel as P
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.parallel import mesh as M
from pctpu_torch.register.pipeline import RegistrationConfig


class LookupSampler:
    """RANSAC draws computed ahead for known valid-match counts: called
    with the whole batch's counts `nv` [B], it checks them and returns
    the draws [B,H,3] made for them."""

    def __init__(self, nv: np.ndarray, draws: np.ndarray):
        self.nv, self.draws = np.asarray(nv), np.asarray(draws)

    def __call__(self, nv: torch.Tensor, H: int) -> torch.Tensor:
        got = nv.cpu().numpy()
        if not np.array_equal(got, self.nv) or H != self.draws.shape[1]:
            raise ValueError(f"draws made for nv {self.nv.tolist()}, H "
                             f"{self.draws.shape[1]}; asked {got.tolist()},"
                             f" {H}")
        return torch.from_numpy(self.draws).to(nv.device)


def _same_on_every_rank(x: torch.Tensor) -> float:
    """max |x - rank 0's x| over the ranks (0 when all hold the same)."""
    d = (x.double() - M.broadcast(x.double())).abs().max()
    return float(M.all_reduce(d[None])[0])


def parallel_checks(inp: dict) -> dict:
    """Every distributed function of `pctpu_torch.parallel` on `inp`'s
    numpy inputs, in one world. Returns rank 0's results, and for each
    the largest difference between ranks."""
    rank, world = dist.get_rank(), dist.get_world_size()
    out, spread = {}, {}

    # meshes and collectives
    m1 = P.make_mesh((("data", -1),))
    m2 = P.make_mesh((("pair", 2), ("point", -1)))
    r = torch.tensor([float(rank)])
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = M.AllReduceSum.apply(x * (rank + 1), m1.group("data"))
    (y * (rank + 1)).sum().backward()
    shard = P.shard_batch(m2, "point")
    out["mesh"] = dict(
        shapes=[m1.shape, m2.shape], coords=[m1.coords, m2.coords],
        sums=[float(M.all_reduce(r, m2.group(a))[0]) for a in ("pair",
                                                             "point")],
        right=int(M.ring_shift(torch.tensor([rank]), 1)[0]),
        left=int(M.ring_shift(torch.tensor([rank]), -1)[0]),
        gathered=M.all_gather(torch.tensor([rank * 10])).tolist(),
        rows=shard.take(torch.arange(8)).tolist(),
        replicated=P.replicated(m1).take(r).tolist(),
        reduce_grad=(y.detach().tolist(), x.grad.tolist()))

    mesh = P.make_mesh((("point", -1),))
    h = inp["halo"]
    d2, idx = P.make_halo_nearest(mesh, h["width"], query_chunk=h["chunk"],
                                  device="cpu")(
        h["src"], h["src_mask"], h["dst"], h["dst_mask"])
    out["halo"] = (d2, idx)
    spread["halo"] = max(_same_on_every_rank(d2), _same_on_every_rank(idx))

    p = inp["icp"]
    T = P.make_point_sharded_icp(mesh, iters=p["iters"],
                                 query_chunk=p["chunk"], device="cpu")(
        p["src"], p["mask"], p["dst"], p["mask"])
    out["icp"], spread["icp"] = T, _same_on_every_rank(T)

    data = P.make_mesh((("data", -1),))
    for key, make in (("pg_dense", P.make_sharded_pose_graph_step),
                      ("pg_sparse", P.make_sharded_pose_graph_step_sparse)):
        g = inp[key]
        kw = {"cg_iters": g["cg_iters"]} if "cg_iters" in g else {}
        poses = make(data, device="cpu", **kw)(
            g["poses"], g["ei"], g["ej"], g["Tm_inv"], g["w"])
        out[key], spread[key] = poses, _same_on_every_rank(poses)

    s = inp["sweep"]
    Ts = P.make_pair_sweep(data, iters=s["iters"], query_chunk=s["chunk"],
                           device="cpu")(s["src"], s["mask"], s["dst"],
                                         s["mask"])
    out["sweep"], spread["sweep"] = Ts, _same_on_every_rank(Ts)

    f = inp["full"]
    reg = P.make_full_pipeline_sweep(
        data, cfg=RegistrationConfig(**f["cfg"]), device="cpu")(
        PointCloud(torch.from_numpy(f["src"]), torch.from_numpy(f["mask"])),
        PointCloud(torch.from_numpy(f["dst"]), torch.from_numpy(f["mask"])),
        f["sampler"])
    out["full"] = reg
    spread["full"] = _same_on_every_rank(reg.T)
    out["spread"] = spread
    out["world"] = world
    return out


def raise_on_rank1():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    M.all_reduce(torch.ones(1))


def hang_on_rank1(seconds: float):
    """Rank 1 outsleeps the world's timeout while rank 0 waits for it."""
    if dist.get_rank() == 1:
        time.sleep(seconds)
    M.all_reduce(torch.ones(1))


def dp_train_checks(inp: dict) -> dict:
    """Two data-parallel train steps of `inp["cfg"]`'s model, each the
    first from the weights `inp["state"]` on the whole batch (`inp["pc"]`,
    `inp["labels"]`): "mask" with the injected keep-mask `inp["mask"]`,
    "generator" with the mask drawn from a generator seeded with
    `inp["seed"]`; then `inp["more"]` steps more; and the BN layers under a
    group against their one-process selves (`inp["bn"]`, when given).
    Returns rank 0's metrics, gradients (the Adam moment over 1 - b1),
    parameters and BN statistics after each first step, the later steps'
    losses, and how far the ranks' parameters lie apart."""
    from pctpu_torch.nn import train as T
    from pctpu_torch.nn.config import TrainConfig
    dev = torch.device(inp["device"])
    cfg = TrainConfig(**inp["cfg"])
    model = T.build_model(cfg, device=dev)
    mesh = P.make_mesh((("data", -1),))
    out = {}
    for how in ("mask", "generator"):
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in inp["state"].items()})
        state = T.TrainState(model, T.make_optimizer(cfg).init(
            list(model.parameters())), 0)
        step = T.make_data_parallel_train_step(model, cfg, mesh, device=dev)
        gen = torch.Generator(dev).manual_seed(inp["seed"])
        if how == "mask":
            m = step(state, inp["pc"], inp["labels"],
                     dropout_mask=torch.from_numpy(inp["mask"]))
        else:
            m = step(state, inp["pc"], inp["labels"], gen)
        out[how] = dict(
            metrics={k: float(v) for k, v in m.items()},
            grads=[mu / 0.1 for mu in state.opt_state.mu],
            state={k: v.clone() for k, v in model.state_dict().items()})
    out["losses"] = [float(step(state, inp["pc"], inp["labels"], gen)["loss"])
                     for _ in range(inp.get("more", 0))]
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    out["spread"] = _same_on_every_rank(flat)
    if "bn" in inp:
        out["bn"] = _bn_checks(inp["bn"], mesh, dev)
    return out


def _bn_checks(bn: dict, mesh, dev) -> dict:
    """`RuntimeBN` and `FoldedDenseBNRelu(stat_stride)` in train mode on
    this rank's rows of bn["x"] under the world group: the outputs
    (gathered), the gradients of sum(out * bn["w"]) with respect to the
    input (gathered) and to the parameters (summed), and the running
    statistics after the step."""
    from pctpu_torch.models import pointnet2 as tp
    shard = P.shard_batch(mesh, "data")
    group = mesh.group("data")
    res = {}
    for name in ("runtime", "folded"):
        gen = torch.Generator().manual_seed(3)
        c = bn["x"].shape[-1]
        layer = (tp.RuntimeBN(c) if name == "runtime" else
                 tp.FoldedDenseBNRelu(c, bn["features"], gen,
                                      stat_stride=bn["stride"]))
        layer.load_state_dict({k: torch.from_numpy(v)
                               for k, v in bn[name].items()})
        layer = layer.to(dev).train()
        x = torch.from_numpy(shard.take(bn["x"])).to(dev).requires_grad_()
        with tp.global_batch_stats(layer, group):
            y = layer(x, 0.5)
        w = torch.from_numpy(shard.take(bn["w"][name])).to(dev)
        params = list(layer.parameters())
        grads = torch.autograd.grad((y * w).sum(), [x, *params])
        res[name] = dict(
            y=shard.gather(y.detach()), dx=shard.gather(grads[0]),
            dparams=[M.all_reduce(g, group) for g in grads[1:]],
            stats=[layer.mean.clone(), layer.var.clone()])
    return res


def one_process_steps(inp: dict) -> dict:
    """`dp_train_checks`' two first steps through the one-process
    `make_train_step` on the whole batch, in this process."""
    from pctpu_torch.nn import train as T
    from pctpu_torch.nn.config import TrainConfig
    dev = torch.device(inp["device"])
    cfg = TrainConfig(**inp["cfg"])
    model = T.build_model(cfg, device=dev)
    out = {"names": [n for n, _ in model.named_parameters()]}
    for how in ("mask", "generator"):
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in inp["state"].items()})
        state = T.TrainState(model, T.make_optimizer(cfg).init(
            list(model.parameters())), 0)
        step = T.make_train_step(model, cfg, device=dev)
        if how == "mask":
            m = step(state, inp["pc"], inp["labels"],
                     dropout_mask=torch.from_numpy(inp["mask"]).to(dev))
        else:
            m = step(state, inp["pc"], inp["labels"],
                     torch.Generator(dev).manual_seed(inp["seed"]))
        out[how] = dict(
            metrics={k: float(v) for k, v in m.items()},
            grads=[(mu / 0.1).cpu() for mu in state.opt_state.mu],
            state={k: v.detach().cpu().clone()
                   for k, v in model.state_dict().items()})
    return out


def _rel(a, b):
    """max |a - b| over b's largest entry."""
    return float((a.double() - b.double()).abs().max()
                 / max(float(b.double().abs().max()), 1e-30))


def _adam_first(g: torch.Tensor) -> torch.Tensor:
    """Adam's first update direction for gradient g: g / (|g| + eps)."""
    g = g.double()
    return g / (g.abs() + 1e-8)


def dp_mismatches(got: dict, ref: dict, names, grad_tol: float = 1e-3,
                  loss_rtol: float = 1e-6) -> list:
    """What differs between a data-parallel first step `got` and the
    one-process one `ref` beyond these bounds: the loss (`loss_rtol`), the
    accuracy and lr (equal); each gradient within `grad_tol` of its norm,
    floored at 1e-3 of the whole gradient's norm. Both bounds sit at the
    float32 floor: BN's backward cancels ~1e6 terms, so summing the batch
    statistics in another order moves a gradient and the loss. On the CPU
    1e-3 and 1e-6; on the card 1e-2 and 1e-5, where the NCCL world of one,
    which only sums BN's statistics as sum / n where the one-process step
    calls mean and var, moved the first layer's gradient by 1.4e-3 of its
    norm (B 32 x 4,096) and the loss by 1.4e-6 relative (B 8 x 512). Each
    parameter as far from the
    one-process one as Adam's first step makes of the two gradients,
    |dp| <= lr (|u(g) - u(g')| + 1e-5) + 1e-6 max|p| with u(g) = g /
    (|g| + eps) (a gradient within the rounding of 0, as the BN bias
    ahead of group-all's max-pool, can move its parameter by up to 2 lr
    either way); the BN statistics within 1e-5 of the largest entry."""
    bad = []
    gl, rl = got["metrics"]["loss"], ref["metrics"]["loss"]
    if abs(gl - rl) > loss_rtol * abs(rl):
        bad.append(("loss", gl, rl))
    for k in ("acc", "lr"):
        if got["metrics"][k] != ref["metrics"][k]:
            bad.append((k, got["metrics"][k], ref["metrics"][k]))
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in ref["grads"])))
    lr = ref["metrics"]["lr"]
    for name, g, r in zip(names, got["grads"], ref["grads"]):
        err = float((g - r).abs().max())
        if err > grad_tol * max(float(r.norm()), 1e-3 * total):
            bad.append(("grad", name, err, float(r.norm())))
        p, q = got["state"][name].double(), ref["state"][name].double()
        allow = (lr * ((_adam_first(g) - _adam_first(r)).abs() + 1e-5)
                 + 1e-6 * float(q.abs().max()))
        if bool(((p - q).abs() > allow).any()):
            bad.append(("param", name, float(((p - q).abs() - allow).max())))
    for name, v in ref["state"].items():
        if name.endswith((".mean", ".var")) and \
                _rel(got["state"][name], v) > 1e-5:
            bad.append(("bn stat", name, _rel(got["state"][name], v)))
    return bad
