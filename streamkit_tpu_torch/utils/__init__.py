# SPDX-License-Identifier: Apache-2.0
"""Utilities: the offline speech-like audio synthesizer and span tracing."""
