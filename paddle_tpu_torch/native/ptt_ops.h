// ptt::flash_fwd registered in C++ (ptt_ops.cc): the K5 library it
// launches and its launch count.
#pragma once

#include <string>

namespace ptt {

// the op's schema, as torch.library.custom_op gives it in attention.py
extern const char* const kFlashFwdSchema;

// dlopen the flash_attention library kernels/build.py builds and bind its
// ptt_flash_fwd; raises c10::Error naming the library on failure
void set_flash_library(const std::string& path);

// K5 launches made by this process's CUDA implementation of the op
long long flash_fwd_launches();

}  // namespace ptt
