# SPDX-License-Identifier: Apache-2.0
"""Node-layer pieces ported so far (the graph nodes themselves come later)."""
