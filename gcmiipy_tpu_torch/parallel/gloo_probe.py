"""Which collectives gloo takes on CUDA tensors, on this machine.

    python -m gcmiipy_tpu_torch.parallel.gloo_probe

For each operation the meshes use (``all_reduce`` in the default group
and in a subgroup made by ``dist.new_group``, as the 2D mesh's row and
column groups are, ``all_gather``, ``broadcast`` and point-to-point by
``batch_isend_irecv``), two spawned
ranks on the first card (gloo, ``tcp://127.0.0.1``) run it on CUDA tensors
and check the values.  Each operation has a process pair of its own, so a
crash fails that operation only.  Prints one JSON line, ``{op: "ok" |
error}``; :data:`distributed.GLOO_CUDA_OPS` lists the ops found "ok".
"""

import datetime
import json
import multiprocessing as mp
import socket
import sys

import torch
import torch.distributed as dist

OPS = ("all_reduce", "all_reduce_subgroup", "all_gather", "broadcast",
       "p2p")
DEADLINE_S = 120


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(op, rank, port, out):
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=2, timeout=datetime.timedelta(seconds=60))
        dev = torch.device("cuda", 0)
        x = torch.full((4, 8), float(rank + 1), device=dev)
        if op == "all_reduce":
            dist.all_reduce(x)
            good = bool((x == 3).all())
        elif op == "all_reduce_subgroup":
            dist.all_reduce(x, group=dist.new_group([0, 1]))
            good = bool((x == 3).all())
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            good = bool((parts[0] == 1).all() and (parts[1] == 2).all())
        elif op == "broadcast":
            dist.broadcast(x, src=0)
            good = bool((x == 1).all())
        else:
            got = torch.empty_like(x)
            peer = 1 - rank
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, peer),
                    dist.P2POp(dist.irecv, got, peer)]):
                req.wait()
            good = bool((got == peer + 1).all())
        torch.cuda.synchronize()
        dist.destroy_process_group()
        out.put((rank, "ok" if good else "wrong values"))
    except Exception as e:  # noqa: BLE001 - reported, not hidden
        out.put((rank, f"{type(e).__name__}: {e}"[:300]))


def probe(op):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(op, r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    for p in procs:
        p.join(DEADLINE_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    while not out.empty():
        r, msg = out.get()
        results[r] = msg
    if len(results) < 2:
        codes = [p.exitcode for p in procs]
        return f"rank(s) died or hung, exit codes {codes}"
    bad = [m for m in results.values() if m != "ok"]
    return bad[0] if bad else "ok"


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({op: probe(op) for op in OPS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
