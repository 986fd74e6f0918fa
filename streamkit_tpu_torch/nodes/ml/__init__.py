# SPDX-License-Identifier: Apache-2.0
"""ML node helpers ported so far: the VAD speech segmenter."""
