"""L7 proxy redirect management.

Re-design of pkg/proxy: the redirect manager allocates
proxy ports (10000-20000, daemon/daemon.go:236) and instantiates the
right L7 matcher per parser type — the reference picks the Go Kafka
proxy or Envoy (proxy.go:217-225); here every parser compiles to
tables on the proxy's device (l7.http, l7.kafka, l7.proxylib's
parsers), request batches are verdicted there, and access-log records
go to the monitor (≙ Envoy access-log socket → pkg/proxy/logger).
"""

from cilium_tpu_torch.proxy.proxy import Proxy, Redirect

__all__ = ["Proxy", "Redirect"]
