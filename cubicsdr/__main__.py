from cubicsdr.app.cli import main
import sys

sys.exit(main())
