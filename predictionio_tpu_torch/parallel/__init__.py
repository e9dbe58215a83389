"""Device placement helpers of the port: the per-model factor cache
(``device_cache``).  The mesh and sharded placement come with the
multi-device slice."""
