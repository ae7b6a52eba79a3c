"""L7 policy on the card: the HTTP DFA scan (http.py, K16), the Kafka
rule match (kafka.py, K17a), the fleet-scoped matcher set
(fleet.py, K17b) and the combined datapath + proxy step
(combined.py)."""
