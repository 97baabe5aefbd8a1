"""Experiments the port runs end to end: ``ablation`` reproduces the JAX
package's quadruplet-vs-triplet ablation."""
