# SPDX-License-Identifier: Apache-2.0
"""Codec nodes ported so far: Opus, host-side entropy coding via the system
libopus. MP3 and FLAC come with a later slice."""


def opus_available() -> bool:
    """Whether the system libopus loads (the Opus kinds register only then)."""
    from .opus import OpusLib

    try:
        OpusLib.get()
    except OSError:
        return False
    return True


def register_codec_nodes(registry) -> None:
    """Register the Opus pair where libopus loads, as the JAX package does;
    without it the kinds stay unregistered (nothing is installed)."""
    if opus_available():
        from .opus import register as register_opus

        register_opus(registry)
