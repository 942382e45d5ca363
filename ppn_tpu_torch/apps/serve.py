"""Serving CLI (port of ``ppn_tpu/apps/serve.py``): N client threads submit
single images, ``PoseServer`` batches them onto the card.

    # self-test and micro-benchmark on synthetic images (without --ckpt-dir
    # a fresh init still drives the whole serving path)
    python -m ppn_tpu_torch.apps.serve --config mpii_r18_384 --selftest 64 \
        --threads 8 --max-batch 32 --window-ms 5 --json \
        --ckpt-dir artifacts/mpii_hero_r5_ema_f16.npz

Prints one JSON line: requests, threads, wall time, images/s, request
latency p50 and p90, the batch-size histogram and the number of requests
whose poses differ from a direct predict; exits 1 on any mismatch.
``--ini`` applies a reference-style config.ini over ``--config``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="mpii_r18_384")
    p.add_argument("--ini", default=None, metavar="PATH",
                   help="reference-style config.ini applied over --config")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint or .npz snapshot to serve "
                        "(default: fresh init)")
    p.add_argument("--flip-tta", action="store_true")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--window-ms", type=float, default=5.0)
    p.add_argument("--selftest", type=int, default=64, metavar="N",
                   help="serve N synthetic images and verify against "
                        "direct Predictor outputs")
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda)")
    args = p.parse_args(argv)

    import numpy as np

    from ppn_tpu_torch.configs import resolve_config
    from ppn_tpu_torch.data.synthetic import SyntheticPoseDataset
    from ppn_tpu_torch.inference import Predictor
    from ppn_tpu_torch.ops.parse import People
    from ppn_tpu_torch.serving import PoseServer

    cfg = resolve_config(args.config, args.ini)
    predictor = Predictor.from_checkpoint(cfg, args.ckpt_dir,
                                          flip_tta=args.flip_tta,
                                          device=args.device)

    n = args.selftest
    ds = SyntheticPoseDataset(cfg, size=min(n, 32), seed=7, num_persons=2)
    # each distinct image rendered once (tens of ms each), then cycled
    distinct = [np.clip(ds[i]["image"] * 255 + 0.5, 0, 255).astype(np.uint8)
                for i in range(len(ds))]
    images = [distinct[i % len(ds)] for i in range(n)]

    with PoseServer(predictor, max_batch=args.max_batch,
                    batch_window_ms=args.window_ms) as server:
        server.warmup()

        lat = [0.0] * n
        results = [None] * n

        def client(tid):
            for i in range(tid, n, args.threads):
                t0 = time.perf_counter()
                results[i] = server.predict(images[i])
                lat[i] = time.perf_counter() - t0

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(args.threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stats = server.stats()

    # Every request must get its own image's poses: batching must not
    # permute or mix requests. A request's result is bitwise equal to a
    # direct predict at the same batch (bucket) shape, since no conv or
    # matmul row reduces across the batch; only the shape can move bits.
    # So each request must equal, exactly, a direct predict at some bucket
    # size the server used.
    buckets = sorted(int(b) for b in stats["batches_by_size"])
    want_by_bucket = {}
    for b in buckets:
        per_img = []
        for s in range(0, n, b):
            chunk = images[s:s + b]
            arr = np.stack(list(chunk) + [np.zeros_like(images[0])]
                           * (b - len(chunk)))
            res = predictor.predict(arr)
            per_img.extend(People(*(f[j] for f in res))
                           for j in range(len(chunk)))
        want_by_bucket[b] = per_img

    def _exact(got, want):
        if not np.array_equal(got.valid, want.valid):
            return False
        v = want.valid
        if not v.any():
            return True
        return (np.array_equal(got.kp_cell[v], want.kp_cell[v])
                and np.array_equal(got.kp_box[v], want.kp_box[v]))

    mism = sum(
        0 if any(_exact(results[i], want_by_bucket[b][i]) for b in buckets)
        else 1
        for i in range(n))
    ls = np.sort(np.asarray(lat)) * 1e3
    out = {
        "requests": n, "threads": args.threads, "wall_s": round(wall, 3),
        "images_per_sec": round(n / wall, 2),
        "p50_ms": round(float(ls[n // 2]), 3),
        "p90_ms": round(float(ls[int(n * 0.9)]), 3),
        "batches_by_size": stats["batches_by_size"],
        "mismatches": mism,
    }
    print(json.dumps(out) if args.json else out)
    return 1 if mism else 0


if __name__ == "__main__":
    raise SystemExit(main())
