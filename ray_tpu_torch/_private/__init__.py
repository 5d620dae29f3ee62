"""Runtime internals (a copy of ray_tpu/_private, where it is a namespace
package): GCS, node manager, core worker, object store, scheduling."""
