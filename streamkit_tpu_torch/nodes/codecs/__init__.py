# SPDX-License-Identifier: Apache-2.0
"""Codec nodes (Opus/MP3/FLAC): host-side entropy coding via system
libraries. Each kind registers only where its library loads, as in the JAX
package; nothing is installed, and no device path depends on them."""


def opus_available() -> bool:
    """Whether the system libopus loads (the Opus kinds register only then)."""
    from .opus import OpusLib

    try:
        OpusLib.get()
    except OSError:
        return False
    return True


def mp3_available() -> bool:
    """Whether the system libmpg123 loads (``audio::mp3::decoder``)."""
    from .mpeg import Mpg123Lib

    try:
        Mpg123Lib.get()
    except OSError:
        return False
    return True


def flac_available() -> bool:
    """Whether the port's libav shim builds and loads (``audio::flac::decoder``)."""
    from .av import av_available

    return av_available()


def register_codec_nodes(registry) -> None:
    """Register the Opus pair, the MP3 decoder and the libav (FLAC) decoder
    where their libraries load; without one its kinds stay unregistered."""
    if opus_available():
        from .opus import register as register_opus

        register_opus(registry)
    if mp3_available():
        from .mpeg import register as register_mpeg

        register_mpeg(registry)
    if flac_available():
        from .av import register as register_av

        register_av(registry)
