"""The codec subsystem: the wire's array codecs (host pack, device
unpack) and the spill tiers' byte codecs, through one registry and one
per-codec stats surface.  Counterpart of
``spark_rapids_tpu/columnar/compression/``; see ``registry.py`` (which
holds the constants ``WIRE_MIN_RATIO`` and ``WIRE_BLOCK_ROWS``)."""

from spark_rapids_tpu_torch.columnar.compression.registry import (  # noqa: F401
    MIN_COMPRESS_BYTES,
    Codec,
    choose_and_encode,
    get_bytes_codec,
    get_codec,
    record_compress,
    record_decompress,
    register_codec,
    registry_items,
    reset_stats,
    stats,
    unregister_codec,
    wire_codec_config,
)
from spark_rapids_tpu_torch.columnar.compression import codecs  # noqa: F401,E402
