import sys

from .application import main

sys.exit(main())
