from otamg.sparse.containers import BSR, COO, CSR, spgemm  # noqa: F401
from otamg.sparse.kernels import ell_spmv  # noqa: F401
from otamg.sparse.ot_assembly import asat_coo  # noqa: F401
