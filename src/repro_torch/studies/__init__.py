"""The paper's accuracy studies on the port (counterpart of the JAX
package's ``benchmarks/table*.py`` and ``fig1_cdf.py``)."""
