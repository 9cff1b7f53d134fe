"""Run logging and checkpoints of the port (its own files and the JAX
package's msgpack files)."""
