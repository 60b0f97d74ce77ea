"""Snapshot downloader for checkpoints and datasets from the HF Hub (the
port's copy of aria_tpu/cli/download.py).

Parity with the reference's download entry points
(gptfast/scripts/download.py:12-29 — model snapshots into
``checkpoints/<repo_id>``; examples/download_data_hf.py:32-52 — dataset
snapshots with retry). One command covers both:

  python -m aria_tpu_torch.cli.download --repo rhymes-ai/Aria
  python -m aria_tpu_torch.cli.download --repo <org>/<dataset> --type dataset \\
      --out /data/<dataset>

The downloaded model dir feeds the importers directly:
``aria_tpu_torch.checkpoint.io.import_hf_lm_serving_int4`` (streamed int4
serving import), ``import_hf_checkpoint`` (training bf16) or
``python -m aria_tpu_torch.cli.serve --model-path <dir>``.

In a zero-egress environment this exits with a clear message instead of
hanging in connect retries.
"""

import argparse
import os
import socket
import sys
import time


def _has_egress(host: str = "huggingface.co", timeout: float = 3.0) -> bool:
    try:
        socket.create_connection((host, 443), timeout=timeout).close()
        return True
    except OSError:
        return False


def download(repo: str, out: str, repo_type: str, token: str | None,
             retries: int, allow: list[str] | None) -> str:
    from huggingface_hub import snapshot_download

    os.makedirs(out, exist_ok=True)
    last: Exception | None = None
    for attempt in range(retries):
        try:
            return snapshot_download(
                repo, local_dir=out, repo_type=repo_type, token=token,
                max_workers=8, allow_patterns=allow or None,
            )
        except Exception as e:  # noqa: BLE001 — transient Hub/network errors
            status = getattr(getattr(e, "response", None), "status_code", None)
            if status == 401:
                raise SystemExit(
                    "401 from the Hub — pass a valid --token to download "
                    "gated/private repos."
                ) from e
            last = e
            print(f"# attempt {attempt + 1}/{retries} failed "
                  f"({type(e).__name__}); retrying...", flush=True)
            time.sleep(min(2.0 ** attempt, 30.0))
    raise SystemExit(f"download failed after {retries} attempts: {last!r}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default="rhymes-ai/Aria",
                    help="Hub repo id (model or dataset)")
    ap.add_argument("--type", dest="repo_type", default="model",
                    choices=("model", "dataset"))
    ap.add_argument("--out", default=None,
                    help="target dir (default checkpoints/<repo>)")
    ap.add_argument("--token", default=os.environ.get("HF_TOKEN"),
                    help="Hub API token (default $HF_TOKEN)")
    ap.add_argument("--retries", type=int, default=5)
    ap.add_argument("--allow", action="append", default=None, metavar="GLOB",
                    help="only files matching GLOB (repeatable), e.g. "
                    "'*.safetensors'")
    args = ap.parse_args()

    if not _has_egress():
        print("no route to huggingface.co (zero-egress environment?) — "
              "place the snapshot manually and point the importer at it.",
              file=sys.stderr)
        raise SystemExit(2)

    out = args.out or os.path.join("checkpoints", args.repo)
    path = download(args.repo, out, args.repo_type, args.token,
                    args.retries, args.allow)
    print(f"snapshot complete: {path}")


if __name__ == "__main__":
    main()
