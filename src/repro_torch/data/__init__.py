from .arena import ArenaClosed, SlabArena, SlotRef
from .codec import decode_sample, encode_sample
from .dataset import ArrayDataset, SyntheticImageDataset, SyntheticTokenDataset
from .loader import build_image_loader, build_lm_loader
from .sampler import CheckpointableSampler
from .shards import (
    AdmissionController,
    FleetMember,
    HashRing,
    HttpShardSource,
    LocalShardSource,
    MembershipRegistry,
    PeerShardServer,
    PeerShardSource,
    RetryingSource,
    ShardCorruption,
    ShardDataset,
    ShardPrefetcher,
    ShardReader,
    ShardWriter,
    SimulatedLatencySource,
    SourceUnavailable,
    TieredSource,
    pack,
)
from .tokenizer import ByteTokenizer
from .transfer import DeviceDecode, DeviceTransfer, to_uint8_wire

__all__ = [
    "encode_sample",
    "decode_sample",
    "ArenaClosed",
    "SlabArena",
    "SlotRef",
    "ArrayDataset",
    "SyntheticImageDataset",
    "SyntheticTokenDataset",
    "CheckpointableSampler",
    "ByteTokenizer",
    "build_image_loader",
    "build_lm_loader",
    "AdmissionController",
    "FleetMember",
    "HashRing",
    "HttpShardSource",
    "LocalShardSource",
    "MembershipRegistry",
    "PeerShardServer",
    "PeerShardSource",
    "RetryingSource",
    "ShardCorruption",
    "ShardDataset",
    "ShardPrefetcher",
    "ShardReader",
    "ShardWriter",
    "SimulatedLatencySource",
    "SourceUnavailable",
    "TieredSource",
    "pack",
    "DeviceDecode",
    "DeviceTransfer",
    "to_uint8_wire",
]
