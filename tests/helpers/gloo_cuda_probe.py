r"""Which gloo collectives and point-to-point ops run with CUDA tensors, two
processes on one card, on a sub-group of a 2-D ``DeviceMesh`` (the port's
spatial, context and pipeline exchanges use the ones that do). Each case runs
in its own pair of processes, killed after 60 s, so that a crash or a hang
shows as that case's result only. On a machine with a CUDA card:

    python3 tests/helpers/gloo_cuda_probe.py
"""
import os
import socket
import subprocess
import sys
import time

CASES = ["send_recv", "isend_irecv", "batch_isend_irecv", "all_gather_into_tensor_sub",
         "reduce_scatter_tensor", "broadcast_sub", "all_reduce_sub", "flatten"]


def child(case):
    import torch
    import torch.distributed as dist
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{os.environ['PORT']}",
                            rank=rank, world_size=2)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "sp"))
    g = mesh.get_group("sp")
    x = torch.full((4, 3), float(rank + 1), device="cuda")
    if case == "send_recv":
        y = torch.empty_like(x)
        if rank == 0:
            dist.send(x, 1, group=g)
            dist.recv(y, 1, group=g)
        else:
            dist.recv(y, 0, group=g)
            dist.send(x, 0, group=g)
        ok = y.eq(2 - rank).all().item()
    elif case == "isend_irecv":
        y = torch.empty_like(x)
        other = 1 - rank
        reqs = [dist.isend(x, other, group=g), dist.irecv(y, other, group=g)]
        for r in reqs:
            r.wait()
        ok = y.eq(2 - rank).all().item()
    elif case == "batch_isend_irecv":
        y = torch.empty_like(x)
        other = 1 - rank
        ops = [dist.P2POp(dist.isend, x, other, group=g), dist.P2POp(dist.irecv, y, other, group=g)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        ok = y.eq(2 - rank).all().item()
    elif case == "all_gather_into_tensor_sub":
        buf = x.new_empty((8, 3))
        dist.all_gather_into_tensor(buf, x, group=g)
        ok = buf[:4].eq(1).all().item() and buf[4:].eq(2).all().item()
    elif case == "reduce_scatter_tensor":
        inp = torch.cat([x, x])
        out = x.new_empty((4, 3))
        dist.reduce_scatter_tensor(out, inp, group=g)
        ok = out.eq(3).all().item()
    elif case == "broadcast_sub":
        dist.broadcast(x, dist.get_global_rank(g, 1), group=g)
        ok = x.eq(2).all().item()
    elif case == "all_reduce_sub":
        dist.all_reduce(x, group=g)
        ok = x.eq(3).all().item()
    elif case == "flatten":
        flat = mesh["data", "sp"]._flatten()
        y = x.clone()
        dist.all_reduce(y, group=flat.get_group())
        ok = y.eq(3).all().item()
    torch.cuda.synchronize()
    print(f"RESULT {case} rank {rank}: {'ok' if ok else 'WRONG'}", flush=True)
    dist.destroy_process_group()


def main():
    import torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    for case in CASES:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, __file__, case],
                                  env={**os.environ, "RANK": str(r), "PORT": str(port)},
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1, 60 - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += "\nTIMEOUT"
            outs.append((p.returncode, out))
        for r, (rc, out) in enumerate(outs):
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
            tail = out.strip().splitlines()[-3:] if rc else []
            print(f"{case} rank {r}: rc {rc} {lines} {tail}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(sys.argv[1])
    else:
        main()
