"""Ground-truth matchers for differential testing (`oracle`): the JAX
package's `hyperscan_tpu.utils`, copied, so the port imports no JAX."""
