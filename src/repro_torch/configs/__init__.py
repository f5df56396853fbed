"""Model configurations of the PyTorch port (its own copies of the JAX
package's ``repro/configs``)."""
