from .fsutils import mkdir, rm_n_mkdir, recur_find_ext, get_files, save_json
from .logging import log_info, log_debug
