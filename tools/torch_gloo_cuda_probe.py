"""Which collectives gloo carries for CUDA tensors in the installed torch:
each op runs in a world of two ranks sharing card 0, a world an op, so a
crash names its op (plain collectives, a 1-D and a 2-D ``DeviceMesh``,
``DTensor.full_tensor``, and a 1 x 2 DTensor MLP step with AdamW).

    python3 tools/torch_gloo_cuda_probe.py

Prints one line a rank and op: its return code (-11: SIGSEGV) and what
it computed.  Needs a CUDA card.
"""
import os
import socket
import subprocess
import sys

OPS = ["all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "barrier", "mesh1d", "full_tensor",
       "mesh2d", "dtensor_mlp"]


def child(rank: int, op: str) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    torch.set_num_threads(1)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", timeout=timedelta(seconds=30))
    x = torch.arange(4.0, device=dev) + rank
    if op == "all_reduce":
        dist.all_reduce(x)
    elif op == "broadcast":
        dist.broadcast(x, 0)
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        x = torch.cat(parts)
    elif op == "all_gather_into_tensor":
        y = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(y, x)
        x = y
    elif op == "reduce_scatter_tensor":
        y = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(y, x)
        x = y
    elif op == "barrier":
        dist.barrier()
    elif op == "mesh1d":
        init_device_mesh("cuda", (2,), mesh_dim_names=("dp",))
    elif op == "full_tensor":
        m = init_device_mesh("cuda", (2,), mesh_dim_names=("dp",))
        x = DTensor.from_local(x, m, [Shard(0)], run_check=False
                               ).full_tensor()
    elif op == "mesh2d":
        init_device_mesh("cuda", (1, 2), mesh_dim_names=("dp", "tp"))
    elif op == "dtensor_mlp":
        m = init_device_mesh("cuda", (1, 2), mesh_dim_names=("dp", "tp"))
        g = torch.Generator().manual_seed(0)
        w = torch.randn(6, 8, generator=g).to(dev)
        w2 = torch.randn(8, 2, generator=g).to(dev)
        inp = torch.randn(5, 6, generator=g).to(dev)
        wd = DTensor.from_local(w[:, 4 * rank:4 * rank + 4], m,
                                [Replicate(), Shard(1)], run_check=False)
        w2d = DTensor.from_local(w2, m, [Replicate(), Replicate()],
                                 run_check=False)
        wd.requires_grad_(True)
        w2d.requires_grad_(True)
        xd = DTensor.from_local(inp, m, [Shard(0), Replicate()],
                                run_check=False)
        p = torch.nn.functional.gelu(xd @ wd) @ w2d
        p = p.redistribute(m, [Shard(0), Replicate()])
        lab = DTensor.from_local(torch.ones(5, 2, device=dev), m,
                                 [Shard(0), Replicate()], run_check=False)
        loss = torch.nn.functional.huber_loss(p, lab)
        loss.backward()
        torch.optim.AdamW([wd, w2d], lr=1e-3).step()
        x = loss.full_tensor().reshape(1)
    torch.cuda.synchronize()
    print(f"OK {op} rank {rank} {x.tolist()}", flush=True)
    dist.destroy_process_group()


def main() -> None:
    for op in OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), op],
            env=dict(os.environ, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                     LOCAL_RANK="0"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=90)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            lines = [ln for ln in out.splitlines()
                     if "OK" in ln or "rror" in ln]
            print(f"[{op}] rank {r} rc={p.returncode}: {lines[-3:]}",
                  flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 2:
        child(int(sys.argv[1]), sys.argv[2])
    else:
        main()
