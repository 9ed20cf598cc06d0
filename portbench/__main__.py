import os

from portbench.harness import main

# end at once: the program's daemon threads must not print after the result
os._exit(main())
