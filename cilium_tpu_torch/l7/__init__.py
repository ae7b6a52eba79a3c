"""L7 policy on the card: the HTTP DFA scan (http.py, K16), the Kafka
rule match (kafka.py, K17a), the fleet-scoped matcher set
(fleet.py, K17b), the combined datapath + proxy step (combined.py) and
the generic proxylib parsers (proxylib.py), among them binary
memcached (memcached.py, K17c).

Generic parsers register themselves by name at import — importing this
package loads the bundled ones (memcached and the proxylib test
parsers), as the reference's proxylib init() hooks do.
"""

from cilium_tpu_torch.l7 import memcached as _memcached  # noqa: F401
from cilium_tpu_torch.l7 import testparsers as _testparsers  # noqa: F401
