"""TFRecord -> simulator JSON pipeline (port of
``gpudrive_lab_tpu/data_utils/process_waymo_files.py``).

Mirror of the reference's CLI (reference:
data_utils/process_waymo_files.py:538-701): iterates WOMD TFRecord shards,
parses Scenario protos, converts via
gpudrive_lab_torch.data_utils.waymo_converter, writes JSONs with
multiprocessing.

Unlike the reference, this pipeline has NO optional dependencies: records
are framed/unframed by gpudrive_lab_torch.data_utils.tfrecord (pure Python)
and parsed with the vendored wire-compatible proto subset
(data_utils/waymo_protos/scenario_lite.proto).  When the official
waymo-open-dataset package is installed its scenario_pb2 is preferred.

Run: python -m gpudrive_lab_torch.data_utils.process_waymo_files \
       --input-dir <tfrecords> --output-dir <jsons>
"""

from __future__ import annotations

import argparse
import json
import os
from multiprocessing import cpu_count, get_context

# fork() after CUDA is initialised in the parent is unsafe (the child
# inherits a CUDA context it cannot use); spawn starts a fresh interpreter
Pool = get_context("spawn").Pool

from gpudrive_lab_torch.data_utils.tfrecord import read_tfrecord
from gpudrive_lab_torch.data_utils.waymo_converter import scenario_to_dict


def _scenario_pb2():
    """Official Scenario proto when available, else the vendored subset."""
    try:  # pragma: no cover - exercised only with waymo-open-dataset
        from waymo_open_dataset.protos import scenario_pb2

        return scenario_pb2
    except ImportError:
        from gpudrive_lab_torch.data_utils.waymo_protos import (
            scenario_lite_pb2,
        )

        return scenario_lite_pb2


def as_proto_iterator(tfrecord_path: str, scenario_pb2=None):
    """Parsed Scenario protos of one shard."""
    pb2 = scenario_pb2 or _scenario_pb2()
    for payload in read_tfrecord(tfrecord_path):
        proto = pb2.Scenario()
        proto.ParseFromString(payload)
        yield proto


def shard_output_base(tfrecord_path: str) -> str:
    """Output basenames must start with 'tfrecord' (the dataloader filter,
    as in the reference) AND stay unique per input shard.  Standard WOMD
    shards ('training.tfrecord-00000-of-01000') keep their shard suffix;
    anything else gets a sanitized unique name with the prefix prepended."""
    raw = os.path.basename(tfrecord_path)
    suffix = raw.split(".")[-1]
    if suffix.startswith("tfrecord") and suffix != "tfrecord":
        return suffix
    return "tfrecord-" + raw.replace(".tfrecord", "").replace(".", "_")


def process_tfrecord(args_tuple):
    tfrecord_path, output_dir = args_tuple
    base = shard_output_base(tfrecord_path)
    n_written = n_filtered = 0
    for i, proto in enumerate(as_proto_iterator(tfrecord_path)):
        name = f"{base}_{i}.json"
        out = scenario_to_dict(proto, name)
        if out is None:
            n_filtered += 1
            continue
        with open(os.path.join(output_dir, name), "w") as f:
            json.dump(out, f)
        n_written += 1
    return tfrecord_path, n_written, n_filtered


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-workers", type=int, default=None)
    args = p.parse_args()

    os.makedirs(args.output_dir, exist_ok=True)
    shards = sorted(
        os.path.join(args.input_dir, f)
        for f in os.listdir(args.input_dir)
        if "tfrecord" in f
    )
    tasks = [(s, args.output_dir) for s in shards]
    with Pool(args.num_workers or cpu_count()) as pool:
        for path, written, filtered in pool.imap_unordered(
            process_tfrecord, tasks
        ):
            print(f"{path}: wrote {written}, filtered {filtered}", flush=True)


if __name__ == "__main__":
    main()
