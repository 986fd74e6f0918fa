# SPDX-License-Identifier: Apache-2.0
"""The port's tools: the learned VAD's trainer and evaluator, the K2 probe."""
