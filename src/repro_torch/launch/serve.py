"""BPMF serving CLI: answer rating queries from an artifact or a server.

One-shot query mode (JSON on stdout)::

    python -m repro_torch.launch.serve --artifact /tmp/bpmf-art --rows 0,1,2 --cols 5,6,7
    python -m repro_torch.launch.serve --artifact /tmp/bpmf-art --user 7 --top-k 10

Micro-batch loop: one JSON request per stdin line, one JSON response per
stdout line (a minimal sidecar-friendly serving loop)::

    printf '{"rows": [0, 1], "cols": [5, 6]}\n{"user": 7, "k": 3}\n' | \\
        python -m repro_torch.launch.serve --artifact /tmp/bpmf-art --jsonl

Client mode: ``--server host:port`` (instead of ``--artifact``) sends the
same requests to a running ``python -m repro_torch.launch.serve_server`` — the
identical request/response schema (:mod:`repro_torch.serve.schema`) drives either
the in-process predictor or the persistent server, so scripts can switch
transports with one flag::

    python -m repro_torch.launch.serve --server 127.0.0.1:8642 --user 7 --top-k 10

Requests: ``{"rows": [...], "cols": [...], "std": bool?}`` for point
predictions, ``{"user": id, "k": n}`` (or ``{"users": [...], "k": n}``)
for top-k. Malformed requests yield ``{"error": ...}`` responses; the loop
keeps serving. The flags are those of ``python -m repro.launch.serve``,
with ``--device cuda|cpu`` (default ``cuda``) in place of ``--devices``:
with ``--artifact`` the predictor runs on the GPU unless ``--device cpu``
is given, and with no GPU and no CPU request the CLI exits with the error
of ``repro_torch.launch.bpmf``. Artifacts from either package serve here.
"""
from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve posterior-mean BPMF predictions from an exported "
                    "artifact, or query a running serve_server.",
    )
    p.add_argument("--artifact", default=None,
                   help="artifact directory written by BPMFEngine.export() / "
                        "repro_torch.launch.bpmf --export-artifact")
    p.add_argument("--server", default=None, metavar="HOST:PORT",
                   help="query a running repro_torch.launch.serve_server instead "
                        "of loading an artifact in-process")
    p.add_argument("--rows", default=None,
                   help="comma-separated user ids for a one-shot prediction batch")
    p.add_argument("--cols", default=None,
                   help="comma-separated movie ids (paired with --rows)")
    p.add_argument("--user", type=int, default=None,
                   help="one-shot top-k: user id to rank the catalog for")
    p.add_argument("--top-k", type=int, default=10,
                   help="number of movies returned with --user")
    p.add_argument("--std", action="store_true",
                   help="include the predictive std (needs retained samples)")
    p.add_argument("--jsonl", action="store_true",
                   help="micro-batch loop: JSONL requests on stdin, JSON "
                        "responses on stdout")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the predictor runs with --artifact (default cuda; "
                        "cpu only when asked)")
    return p


def _parse_ids(text: str, flag: str) -> list[int]:
    try:
        return [int(x) for x in text.split(",") if x.strip() != ""]
    except ValueError as e:
        raise SystemExit(f"{flag} must be a comma-separated id list: {e}")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if (args.artifact is None) == (args.server is None):
        print("exactly one of --artifact or --server is required", file=sys.stderr)
        return 2

    from repro_torch.serve import (
        ArtifactError,
        PosteriorPredictor,
        RequestError,
        ServeClient,
        ServeConnectionError,
        parse_request,
        run_request,
    )
    from repro_torch.serve.schema import error_response
    from repro_torch.utils import resolve_device

    if args.server is not None:
        try:
            client = ServeClient(args.server)
            health = client.health()
        except (ValueError, ServeConnectionError) as e:
            print(f"cannot reach server: {e}", file=sys.stderr)
            return 1
        art = health.get("artifact", {})
        print(
            f"querying server {args.server}: R {art.get('num_users')} x "
            f"{art.get('num_movies')}, K={art.get('K')}, "
            f"backend={art.get('backend')}, "
            f"generation={health.get('generation')}",
            file=sys.stderr,
        )

        def handle_safe(req: dict) -> dict:
            # server-side validation comes back as an {"error": ...} body;
            # transport failures become error responses too, so the JSONL
            # loop keeps serving
            try:
                return client.request(req)
            except ServeConnectionError as e:
                return {"error": f"{type(e).__name__}: {e}"}
    else:
        device = resolve_device(args.device)  # no GPU and no --device cpu: raise
        try:
            predictor = PosteriorPredictor.load(args.artifact, device=device)
        except ArtifactError as e:
            print(f"cannot load artifact: {e}", file=sys.stderr)
            return 1
        meta = predictor.meta
        print(
            f"serving artifact {args.artifact}: R {meta.num_users} x "
            f"{meta.num_movies}, K={meta.K}, backend={meta.backend}, "
            f"{meta.num_mean_samples} posterior samples averaged, "
            f"{meta.num_kept_samples} kept for std, device={device}",
            file=sys.stderr,
        )

        def handle_safe(req: dict) -> dict:
            # invalid queries (bad shapes, out-of-range ids, --std without
            # retained samples) become error responses in every mode,
            # never tracebacks — same schema the server speaks
            try:
                return run_request(predictor, parse_request(req))
            except (RequestError, ValueError, KeyError, TypeError) as e:
                return error_response(e)

    if args.jsonl:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                resp = handle_safe(json.loads(line))
            except ValueError as e:  # json.JSONDecodeError
                resp = {"error": f"{type(e).__name__}: {e}"}
            print(json.dumps(resp), flush=True)
        return 0

    if args.user is not None:
        req = {"user": args.user, "k": args.top_k}
    elif args.rows is not None and args.cols is not None:
        req = {"rows": _parse_ids(args.rows, "--rows"),
               "cols": _parse_ids(args.cols, "--cols")}
        if args.std:
            req["std"] = True
    else:
        print("one-shot mode needs --rows AND --cols (or --user, or --jsonl)",
              file=sys.stderr)
        return 2
    resp = handle_safe(req)
    if "error" in resp:
        print(json.dumps(resp), file=sys.stderr)
        return 1
    print(json.dumps(resp))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
