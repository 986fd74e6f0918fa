# SPDX-License-Identifier: Apache-2.0
import sys

from .main import main

sys.exit(main())
