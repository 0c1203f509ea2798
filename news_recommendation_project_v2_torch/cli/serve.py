"""Request-serving CLI: load a tower checkpoint (a ``torch.save``d port
``state_dict``) and an id-keyed embedding dump, and answer rank / rank_batch /
retrieve requests over HTTP (JSON) or stdio (JSONL).

    # HTTP:   POST /rank {"history": [...], "candidates": [...]}
    #         POST /rank_batch {"requests": [{"history": [...], "candidates": [...]}, ...]}
    #         POST /retrieve {"history": [...], "k": 10}
    #         GET  /healthz
    nrtorch-serve EMB_DIR MINDsmall_dev --ckpt tower.pt --port 8080

    # stdio: one JSON request per line, "op" selects the endpoint
    echo '{"op": "retrieve", "history": ["N1"], "k": 5}' | nrtorch-serve EMB_DIR MINDsmall_dev --stdio

``--mesh DATA,MODEL`` serves over DATA x MODEL ranks, one process each,
started by torchrun: the tables row-shard over MODEL, ``rank_batch``'s
groups over DATA. Rank 0 runs the front end and the others follow it
(``serve.Ranker.follow``); when rank 0's front end ends, it releases them.

    torchrun --nproc-per-node 2 -m news_recommendation_project_v2_torch.cli.serve \
        EMB_DIR MINDsmall_dev --ckpt tower.pt --port 8080 --mesh 1,2

NCCL joins the ranks on CUDA (one card each), gloo on the CPU
(``--device cpu``); ``--dist-backend gloo`` lets ranks share a card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from ..config import TowerConfig, tower_kwargs_for_dim
from ..device import resolve_device
from ..models import average_pool, build_tower, check_tower_input_dim
from ..ops.encode import load_embeddings
from ..serve import Ranker


def build_ranker(
    emb_dir: Path,
    dataset: str,
    ckpt: Path | None = None,
    tower_config: TowerConfig | None = None,
    device=None,
    mesh=None,
) -> Ranker:
    """Assemble a Ranker from on-disk artifacts: the id-keyed embedding dump
    and, when ``ckpt`` is given, a tower ``state_dict`` (``torch.save``)
    loaded strictly into a tower of ``tower_config``. Without a checkpoint the
    ranker serves the mean-pooled history. ``mesh``: every rank builds it
    (``Ranker(mesh=)``)."""
    device = resolve_device(device)
    emb_dir = Path(emb_dir)
    ids_path = emb_dir / f"{dataset}_ids.npy"
    if not ids_path.exists():
        raise FileNotFoundError(
            f"{ids_path} missing: serving needs an id-keyed dump (re-run "
            "save_emb; positional-only dumps cannot resolve request news ids)"
        )
    news_ids = [str(n) for n in np.load(ids_path)]
    try:
        emb, query = load_embeddings(emb_dir, dataset, with_query=True)
    except FileNotFoundError:
        emb, query = load_embeddings(emb_dir, dataset), None

    if ckpt is None:
        return Ranker(average_pool, emb, news_ids, query_news_emb=query, mesh=mesh, device=device)

    cfg = tower_config or TowerConfig(kind="latent")
    check_tower_input_dim(cfg, int(emb.shape[1]))
    tower = build_tower(cfg)
    tower.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    return Ranker(tower, emb, news_ids, query_news_emb=query, mesh=mesh, device=device)


def _pairs(ranked) -> list:
    # Unknown candidates score -inf (ranked last); strict JSON has no
    # Infinity literal, so they serialize as null.
    return [[c, s if math.isfinite(s) else None] for c, s in ranked]


def dispatch(ranker: Ranker, op: str, req: dict) -> dict:
    """One request -> one JSON-serializable response. Raises ValueError on
    malformed requests (mapped to HTTP 400 / stdio {"error": ...})."""
    if op == "rank":
        return {"ranked": _pairs(ranker.rank(req["history"], req["candidates"]))}
    if op == "rank_batch":
        results = ranker.rank_batch(
            [(r["history"], r["candidates"]) for r in req["requests"]]
        )
        return {"results": [_pairs(ranked) for ranked in results]}
    if op == "retrieve":
        return {
            "ranked": _pairs(ranker.retrieve(req["history"], k=int(req.get("k", 10))))
        }
    raise ValueError(f"unknown op {op!r} (expected rank | rank_batch | retrieve)")


def make_server(ranker: Ranker, host: str = "127.0.0.1", port: int = 0):
    """A ThreadingHTTPServer bound to (host, port); port 0 picks a free one
    (``server.server_address[1]`` reports it). Handler threads share the
    ranker; their device work queues on one CUDA stream."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "news": len(ranker.id_of)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
                self._reply(200, dispatch(ranker, self.path.lstrip("/"), req))
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})

        def log_message(self, *args):  # quiet: JSONL access log on stderr
            print(json.dumps({"addr": self.client_address[0], "line": args[0] % args[1:]}), file=sys.stderr)

    return ThreadingHTTPServer((host, port), Handler)


def serve_stdio(ranker: Ranker, stdin=None, stdout=None) -> None:
    """JSONL request/response loop: {"op": ..., ...} per line in, one JSON
    object per line out ({"error": ...} for malformed requests)."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError(f"request must be a JSON object, got {type(req).__name__}")
            out = dispatch(ranker, req.pop("op"), req)
        except (KeyError, ValueError, TypeError) as e:
            out = {"error": str(e)}
        print(json.dumps(out), file=stdout, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("emb_dir", type=Path)
    parser.add_argument("dataset", help="embedding dump name, e.g. MINDsmall_dev")
    parser.add_argument("--ckpt", type=Path, default=None,
                        help="tower state_dict saved with torch.save (omit = "
                             "mean-pool scorer)")
    parser.add_argument("--tower", default="latent",
                        choices=["latent", "final_attention", "transformer"])
    parser.add_argument("--dim", type=int, default=None,
                        help="tower dim override; must match the checkpoint's "
                             "training --dim")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the kernels' "
                             "plain versions)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--stdio", action="store_true",
                        help="serve JSONL over stdin/stdout instead of HTTP")
    parser.add_argument("--warmup", action="store_true",
                        help="run every shape bucket once before serving "
                             "(builds the kernels up front)")
    parser.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                        help="serve over DATA x MODEL ranks (run under torchrun): "
                             "the tables row-shard over MODEL, rank_batch groups over DATA")
    parser.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                        help="the mesh's backend (default: nccl on CUDA, gloo on the CPU; "
                             "gloo lets ranks share a card)")
    args = parser.parse_args(argv)
    if args.stdio == (args.port is not None):
        parser.error("exactly one of --port / --stdio is required")
    mesh = None
    if args.mesh:
        from ..config import MeshConfig

        try:
            data_size, model_size = (int(x) for x in args.mesh.split(","))
        except ValueError:
            parser.error("--mesh wants DATA,MODEL integers, e.g. 1,2")
        if data_size < 1 or model_size < 1:
            parser.error("--mesh wants positive sizes")
        mesh_config = MeshConfig(data_size=data_size, model_size=model_size)
    try:
        if args.mesh:
            from ..parallel import build_mesh

            mesh = build_mesh(mesh_config, backend=args.dist_backend, device=args.device)
        _serve(args, mesh)
    finally:
        # Every rank leaves _serve after close()'s hand-shake (the followers'
        # follow() joins it), so no rank tears the groups down while
        # another is still inside the last broadcast.
        if args.mesh and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _serve(args, mesh) -> None:
    """Every rank builds the ranker; rank 0 (or the one process) serves and
    then closes it, the other ranks follow until that close."""
    ranker = build_ranker(
        args.emb_dir,
        args.dataset,
        args.ckpt,
        TowerConfig(kind=args.tower, **tower_kwargs_for_dim(args.dim)),
        device=args.device,
        mesh=mesh,
    )
    if mesh is not None and mesh.rank != 0:
        ranker.follow()
        return
    try:
        _front_end(ranker, args, mesh)
    finally:
        ranker.close()


def _front_end(ranker: Ranker, args, mesh) -> None:
    """Rank 0's (or the one process's) warm-up and HTTP or stdio loop."""
    if mesh is not None and mesh.size > 1:
        # Under the process group's timeout (10 minutes), so that idle
        # followers keep waiting while a dead rank 0 still fails them.
        ranker.keep_alive(60.0)
    if args.warmup:
        t0 = time.perf_counter()
        n = ranker.warmup()
        print(f"warmed {n} shapes in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    if args.stdio:
        serve_stdio(ranker)
        return
    server = make_server(ranker, args.host, args.port)
    print(
        f"serving {len(ranker.id_of)} news on "
        f"http://{args.host}:{server.server_address[1]}",
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
