// Error-check macros for the port's native host library.
//
// A copy of the JAX package's `native/src/mfa_native_error.hpp` under the
// port's names.  Library code reached through ctypes must not kill the
// Python interpreter: failed preconditions set a thread-local error
// message the binding surfaces as a Python exception; only genuinely
// unrecoverable states abort.
#pragma once

#include <cstdio>
#include <cstdlib>

namespace mfa_native {

extern thread_local char g_error[256];

void set_error(const char* fmt, ...);

}  // namespace mfa_native

#define MFA_NATIVE_PRECONDITION(cond, ...)          \
  do {                                           \
    if (!(cond)) {                               \
      ::mfa_native::set_error(__VA_ARGS__);         \
      return MFA_NATIVE_ERR_PRECONDITION;           \
    }                                            \
  } while (0)

#define MFA_NATIVE_FATAL(...)                       \
  do {                                           \
    std::fprintf(stderr, "mfa_native fatal: ");     \
    std::fprintf(stderr, __VA_ARGS__);           \
    std::fprintf(stderr, "\n");                  \
    std::abort();                                \
  } while (0)

enum mfa_native_status {
  MFA_NATIVE_OK = 0,
  MFA_NATIVE_ERR_PRECONDITION = 1,
  MFA_NATIVE_ERR_NOT_FOUND = 2,
  MFA_NATIVE_ERR_IO = 3,
};
