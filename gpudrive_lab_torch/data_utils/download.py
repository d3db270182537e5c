"""Dataset download from the Hugging Face hub (port of
``gpudrive_lab_tpu/data_utils/download.py``).

Mirror of the reference's dataset distribution flow (reference:
README.md dataset section + data_utils/post_processing.py group flattening):
pull a processed-scenes dataset snapshot and flatten/validate it.  Gated on
huggingface_hub and network access."""

from __future__ import annotations

import argparse


def download_dataset(repo_id: str, local_dir: str, revision: str | None = None):
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "huggingface_hub is not installed in this environment"
        ) from e
    path = snapshot_download(
        repo_id=repo_id,
        repo_type="dataset",
        local_dir=local_dir,
        revision=revision,
    )
    from gpudrive_lab_torch.data_utils.post_processing import process_directory

    valid, invalid = process_directory(local_dir)
    return path, valid, invalid


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--repo-id", required=True)
    p.add_argument("--local-dir", required=True)
    p.add_argument("--revision", default=None)
    args = p.parse_args()
    path, valid, invalid = download_dataset(
        args.repo_id, args.local_dir, args.revision
    )
    print(f"downloaded to {path}: {valid} valid scenes, {invalid} removed")


if __name__ == "__main__":
    main()
