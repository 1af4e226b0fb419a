import sys

from gpbench.run import main

sys.exit(main())
