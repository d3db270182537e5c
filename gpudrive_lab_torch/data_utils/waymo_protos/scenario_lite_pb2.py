# -*- coding: utf-8 -*-
# The serialized FileDescriptorProto of scenario_lite.proto beside this file
# (file name gpudrive_lab_torch/data_utils/waymo_protos/scenario_lite.proto,
# package gpudrive_lab_torch.waymo_lite), in the layout of protoc's Python
# output; regenerate from the repository root with
#   protoc --python_out=. gpudrive_lab_torch/data_utils/waymo_protos/scenario_lite.proto
# The file name and package differ from the JAX package's copy, so both
# register in protobuf's default descriptor pool in one process.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n>gpudrive_lab_torch/data_utils/waymo_protos/scenario_lite.proto\x12\x1dgpudrive_lab_torch.waymo_lite"+\n\x08MapPoint\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01"\x85\x01\n\nLaneCenter\x12\x17\n\x0fspeed_limit_mph\x18\x01 \x01(\x01\x12\x0c\n\x04type\x18\x02 \x01(\x05\x12\x15\n\rinterpolating\x18\x03 \x01(\x08\x129\n\x08polyline\x18\x08 \x03(\x0b2\'.gpudrive_lab_torch.waymo_lite.MapPoint"S\n\x08RoadEdge\x12\x0c\n\x04type\x18\x01 \x01(\x05\x129\n\x08polyline\x18\x02 \x03(\x0b2\'.gpudrive_lab_torch.waymo_lite.MapPoint"S\n\x08RoadLine\x12\x0c\n\x04type\x18\x01 \x01(\x05\x129\n\x08polyline\x18\x02 \x03(\x0b2\'.gpudrive_lab_torch.waymo_lite.MapPoint"S\n\x08StopSign\x12\x0c\n\x04lane\x18\x01 \x03(\x03\x129\n\x08position\x18\x02 \x01(\x0b2\'.gpudrive_lab_torch.waymo_lite.MapPoint"E\n\tCrosswalk\x128\n\x07polygon\x18\x01 \x03(\x0b2\'.gpudrive_lab_torch.waymo_lite.MapPoint"E\n\tSpeedBump\x128\n\x07polygon\x18\x01 \x03(\x0b2\'.gpudrive_lab_torch.waymo_lite.MapPoint"D\n\x08Driveway\x128\n\x07polygon\x18\x01 \x03(\x0b2\'.gpudrive_lab_torch.waymo_lite.MapPoint"\xd9\x03\n\nMapFeature\x12\n\n\x02id\x18\x01 \x01(\x03\x129\n\x04lane\x18\x03 \x01(\x0b2).gpudrive_lab_torch.waymo_lite.LaneCenterH\x00\x12<\n\troad_line\x18\x04 \x01(\x0b2\'.gpudrive_lab_torch.waymo_lite.RoadLineH\x00\x12<\n\troad_edge\x18\x05 \x01(\x0b2\'.gpudrive_lab_torch.waymo_lite.RoadEdgeH\x00\x12<\n\tstop_sign\x18\x07 \x01(\x0b2\'.gpudrive_lab_torch.waymo_lite.StopSignH\x00\x12=\n\tcrosswalk\x18\x08 \x01(\x0b2(.gpudrive_lab_torch.waymo_lite.CrosswalkH\x00\x12>\n\nspeed_bump\x18\t \x01(\x0b2(.gpudrive_lab_torch.waymo_lite.SpeedBumpH\x00\x12;\n\x08driveway\x18\n \x01(\x0b2\'.gpudrive_lab_torch.waymo_lite.DrivewayH\x00B\x0e\n\x0cfeature_data"r\n\x16TrafficSignalLaneState\x12\x0c\n\x04lane\x18\x01 \x01(\x03\x12\r\n\x05state\x18\x02 \x01(\x05\x12;\n\nstop_point\x18\x03 \x01(\x0b2\'.gpudrive_lab_torch.waymo_lite.MapPoint"]\n\x0fDynamicMapState\x12J\n\x0blane_states\x18\x01 \x03(\x0b25.gpudrive_lab_torch.waymo_lite.TrafficSignalLaneState"\xba\x01\n\x0bObjectState\x12\x10\n\x08center_x\x18\x02 \x01(\x01\x12\x10\n\x08center_y\x18\x03 \x01(\x01\x12\x10\n\x08center_z\x18\x04 \x01(\x01\x12\x0e\n\x06length\x18\x05 \x01(\x02\x12\r\n\x05width\x18\x06 \x01(\x02\x12\x0e\n\x06height\x18\x07 \x01(\x02\x12\x0f\n\x07heading\x18\x08 \x01(\x02\x12\x12\n\nvelocity_x\x18\t \x01(\x02\x12\x12\n\nvelocity_y\x18\n \x01(\x02\x12\r\n\x05valid\x18\x0b \x01(\x08"d\n\x05Track\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x13\n\x0bobject_type\x18\x02 \x01(\x05\x12:\n\x06states\x18\x03 \x03(\x0b2*.gpudrive_lab_torch.waymo_lite.ObjectState"=\n\x12RequiredPrediction\x12\x13\n\x0btrack_index\x18\x01 \x01(\x05\x12\x12\n\ndifficulty\x18\x02 \x01(\x05"\x9e\x03\n\x08Scenario\x12\x1a\n\x12timestamps_seconds\x18\x01 \x03(\x01\x12\x1a\n\x12current_time_index\x18\x02 \x01(\x05\x124\n\x06tracks\x18\x03 \x03(\x0b2$.gpudrive_lab_torch.waymo_lite.Track\x12J\n\x12dynamic_map_states\x18\x04 \x03(\x0b2..gpudrive_lab_torch.waymo_lite.DynamicMapState\x12\x13\n\x0bscenario_id\x18\x05 \x01(\t\x12?\n\x0cmap_features\x18\x06 \x03(\x0b2).gpudrive_lab_torch.waymo_lite.MapFeature\x12\x17\n\x0fsdc_track_index\x18\x07 \x01(\x05\x12\x1b\n\x13objects_of_interest\x18\x08 \x03(\x05\x12L\n\x11tracks_to_predict\x18\n \x03(\x0b21.gpudrive_lab_torch.waymo_lite.RequiredPrediction')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gpudrive_lab_torch.data_utils.waymo_protos.scenario_lite_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MAPPOINT._serialized_start=97
  _MAPPOINT._serialized_end=140
  _LANECENTER._serialized_start=143
  _LANECENTER._serialized_end=276
  _ROADEDGE._serialized_start=278
  _ROADEDGE._serialized_end=361
  _ROADLINE._serialized_start=363
  _ROADLINE._serialized_end=446
  _STOPSIGN._serialized_start=448
  _STOPSIGN._serialized_end=531
  _CROSSWALK._serialized_start=533
  _CROSSWALK._serialized_end=602
  _SPEEDBUMP._serialized_start=604
  _SPEEDBUMP._serialized_end=673
  _DRIVEWAY._serialized_start=675
  _DRIVEWAY._serialized_end=743
  _MAPFEATURE._serialized_start=746
  _MAPFEATURE._serialized_end=1219
  _TRAFFICSIGNALLANESTATE._serialized_start=1221
  _TRAFFICSIGNALLANESTATE._serialized_end=1335
  _DYNAMICMAPSTATE._serialized_start=1337
  _DYNAMICMAPSTATE._serialized_end=1430
  _OBJECTSTATE._serialized_start=1433
  _OBJECTSTATE._serialized_end=1619
  _TRACK._serialized_start=1621
  _TRACK._serialized_end=1721
  _REQUIREDPREDICTION._serialized_start=1723
  _REQUIREDPREDICTION._serialized_end=1784
  _SCENARIO._serialized_start=1787
  _SCENARIO._serialized_end=2201
# @@protoc_insertion_point(module_scope)
