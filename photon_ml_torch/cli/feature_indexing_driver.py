"""Feature indexing driver: scan data, build and save index maps.

Counterpart of ``photon_ml_tpu/cli/feature_indexing_driver.py``: one host
pass over the records (JSONL or Avro) → deterministic sorted-order JSON
maps a feature shard and an entity key, the same files the JAX package
writes (``io.index_map``).  Prebuilt maps let training (``index_dir``)
and scoring skip the scan and keep train and score indices in agreement.
Host only: nothing here touches the card.  The reference's telemetry and
monitor flags are ROADMAP A8b and D3.

Usage::

    python -m photon_ml_torch.cli.feature_indexing_driver \\
        --input data.jsonl --output-dir maps/ [--shards global user_re]
"""

from __future__ import annotations

import argparse
import json

from photon_ml_torch.io.dataset import build_index_maps
from photon_ml_torch.io.index_map import save_index_maps
from photon_ml_torch.utils.run_log import RunLogger


def run(input_path: str, output_dir: str,
        shards: list[str] | None = None,
        entity_keys: list[str] | None = None,
        log: RunLogger | None = None) -> dict:
    """Build and save the maps; returns their sizes."""
    with (log or RunLogger()) as log:
        with log.timed("build_index_maps", input=input_path):
            feature_maps, entity_maps = build_index_maps(
                input_path, shards, entity_keys)
        save_index_maps(output_dir, feature_maps, entity_maps)
        sizes = {
            "features": {s: len(m) for s, m in feature_maps.items()},
            "entities": {k: len(m) for k, m in entity_maps.items()},
        }
        log.event("index_maps_written", output_dir=output_dir, **sizes)
        return sizes


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(
        description="photon_ml_torch feature indexing driver")
    parser.add_argument("--input", required=True,
                        help="JSONL or Avro data file")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--shards", nargs="*", default=None,
                        help="feature shards to index (default: all)")
    parser.add_argument("--entity-keys", nargs="*", default=None,
                        help="entity id keys to index (default: all)")
    args = parser.parse_args(argv)
    sizes = run(args.input, args.output_dir, args.shards, args.entity_keys)
    # The last line of stdout: the maps' sizes, as JSON.
    print(json.dumps(sizes))
    return sizes


if __name__ == "__main__":
    main()
