"""Vendored wire-compatible subset of the WOMD Scenario proto schema (the
port's own copy of ``gpudrive_lab_tpu/data_utils/waymo_protos``).

``scenario_lite_pb2`` holds the descriptor of ``scenario_lite.proto``
(checked in).  Field numbers match the public waymo-open-dataset schema, so
these messages parse real WOMD TFRecord payloads without the tensorflow /
waymo-open-dataset dependencies the reference pipeline requires
(reference: data_utils/process_waymo_files.py imports scenario_pb2).  The
descriptor's file name and package are the port's own, so it and the JAX
package's copy register side by side in protobuf's default pool.
"""
