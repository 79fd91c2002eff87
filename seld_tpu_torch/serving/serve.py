"""Serve the port's window and clip artifacts and streaming bundles over
HTTP (scripts/serve.py).

    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --out ss5_window.npz
    python -m seld_tpu_torch.serving.serve --artifact ss5_window.npz \
        --port 8765 --batch_window_ms 2

    # bulk scoring of whole 60-s clips ([3000, 64, 7] a request):
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --unit clip --out ss5_clip.npz
    python -m seld_tpu_torch.serving.serve --artifact ss5_clip.npz

    # live streams (/v1/stream/<sid>/push, 1-s pushes of [50, 64, 7]):
    python -m seld_tpu_torch.inference.export_model --model_config SS5 \
        --unit stream --out ss5_stream
    python -m seld_tpu_torch.serving.serve --bundle ss5_stream \
        --max_sessions 64

    # client (stdlib): seld_tpu_torch.serving.client.SELDClient
    #   sed, doa = SELDClient(port=8765).score(x)
    #   sed, doa = SELDClient(port=8765).stream_push("mic0", feats)

Protocol: npy request bodies, npz responses (route table in
seld_tpu_torch/serving/server.py). The XLA compilation cache (--cache_dir)
has no counterpart: nothing is compiled at serve time but the kernels,
which build once into build/kernels/.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", default="",
                    help="default window or clip artifact "
                         "(seld_tpu_torch.inference.export_model), served "
                         "by /v1/score")
    ap.add_argument("--model", action="append", default=[],
                    metavar="NAME=PATH",
                    help="additional named artifact, served by "
                         "/v1/score?model=NAME (repeatable); GET /v1/models "
                         "lists them, POST /v1/reload hot-swaps all from "
                         "their files")
    ap.add_argument("--bundle", default="",
                    help="streaming bundle directory (export_model --unit "
                         "stream), served by /v1/stream/<sid>/...")
    ap.add_argument("--max_sessions", type=int, default=64,
                    help="live streaming sessions before new ones get 429")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--batch_window_ms", type=float, default=0.0,
                    help="> 0: micro-batch concurrent /v1/score requests "
                         "into one device dispatch")
    ap.add_argument("--max_batch", type=int, default=32,
                    help="dispatch once this many rows are queued")
    ap.add_argument("--no_bucket_pad", action="store_true",
                    help="disable power-of-two padding of coalesced "
                         "dispatches")
    ap.add_argument("--warmup_buckets", default="",
                    help="CSV of batch sizes to run once at startup, e.g. "
                         "'1,8,32' — keeps first-request latency flat")
    ap.add_argument("--warmup", action="store_true",
                    help="run one dummy dispatch per model before binding "
                         "(clip artifacts: one clip; --warmup_buckets skips "
                         "them, having no batch axis)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.artifact and not args.model and not args.bundle:
        ap.error("need --artifact, --model and/or --bundle")
    named = {}
    for spec in args.model:
        if "=" not in spec:
            ap.error(f"--model wants NAME=PATH, got {spec!r}")
        name, path = spec.split("=", 1)
        if name in named or name == "default":
            ap.error(f"duplicate --model name {name!r}")
        named[name] = path

    import torch

    from seld_tpu_torch.serving.server import SELDServer, serve

    service = SELDServer(artifact=args.artifact or None,
                         bundle=args.bundle or None,
                         max_sessions=args.max_sessions,
                         artifacts=named or None,
                         batch_window_ms=args.batch_window_ms,
                         max_batch=args.max_batch,
                         bucket_pad=not args.no_bucket_pad,
                         device=args.device)
    sizes = ([1] if args.warmup else []) + [
        int(b) for b in args.warmup_buckets.split(",") if b]
    for name, slot in service._slots.items():
        art = slot.artifact
        if art.unit == "clip":
            shapes = [art.input_shape] if args.warmup else []
        else:
            shapes = [(art.batch or b, *art.input_shape) for b in sizes]
        for shape in shapes:
            service.score(torch.zeros(shape, dtype=art.dtype), model=name)
            print(f"warmup: score[{name}] {shape} ok", flush=True)

    httpd = serve(service, args.host, args.port)
    print(f"serving {service.health()['units']} on "
          f"http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
        httpd.server_close()


if __name__ == "__main__":
    main()
