// ray_tpu_torch cross-language C++ task/actor API (header-only): a copy
// of ray_tpu/_native/cross_lang.hpp, wire format byte for byte, so one
// library built against either header serves both packages.
//
// Reference parity: ray.cross_language / the Ray C++ worker API
// (reference: python/ray/cross_language.py, cpp/include/ray/api.h) lets a
// Python driver invoke functions and actors implemented in C++.  Ray runs
// them in a dedicated C++ worker binary speaking the raylet gRPC protocol;
// in ray_tpu's single-controller runtime the TPU-first redesign is
// IN-PROCESS: a user shared library is dlopen()ed inside the (Python)
// worker that the scheduler already placed, and invoked through the stable
// C ABI below.  No extra process hop, no second wire protocol; arguments
// make one encode into a compact wire buffer whose array payloads C++
// reads in place (borrowed, copy-on-misalignment).
//
// User model:
//
//   #include "cross_lang.hpp"
//   static xl::Value add(const std::vector<xl::Value>& a) {
//     return xl::Value(a.at(0).as_int() + a.at(1).as_int());
//   }
//   XL_FUNC(add)
//
//   struct Counter : xl::Actor {
//     long long n = 0;
//     explicit Counter(const std::vector<xl::Value>& a) {
//       if (!a.empty()) n = a[0].as_int();
//     }
//     xl::Value call(const std::string& m,
//                    const std::vector<xl::Value>& a) override {
//       if (m == "inc") { n += a.empty() ? 1 : a[0].as_int(); return xl::Value(n); }
//       if (m == "get") return xl::Value(n);
//       throw std::runtime_error("Counter: unknown method " + m);
//     }
//   };
//   XL_ACTOR(Counter)
//
//   XL_MODULE()   // exactly once per shared library: emits the C ABI
//
// Build:  g++ -O2 -std=c++17 -shared -fPIC -I <ray_tpu_torch/_native> mylib.cc -o libmy.so
// Call from Python:  f = ray_tpu_torch.cross_language.cpp_function("libmy.so", "add")
//                    ray_tpu_torch.get(f.remote(2, 3))  # -> 5
//
// Wire format (shared with ray_tpu_torch/cross_language.py, little-endian):
//   value := tag payload
//     'N'                         nil
//     'T' / 'F'                   bool
//     'i' int64                   integer
//     'd' float64                 float
//     's' u32 len + utf-8 bytes   str
//     'b' u32 len + raw bytes     bytes
//     'l' u32 count + value*      list/tuple
//     'm' u32 count + (value value)*   dict
//     'a' u8 dtype, u8 ndim, u64 shape[ndim], raw C-order data   ndarray
//   dtype codes: 1=f32 2=f64 3=i8 4=i32 5=i64 6=u8 7=u32 8=u64 9=bool
#pragma once

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <functional>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace xl {

static_assert(sizeof(double) == 8, "xl wire format needs 64-bit doubles");

enum class Kind : uint8_t { Nil, Bool, Int, Float, Str, Bytes, List, Map, Array };

enum class DType : uint8_t {
  F32 = 1, F64 = 2, I8 = 3, I32 = 4, I64 = 5, U8 = 6, U32 = 7, U64 = 8, Bool = 9,
};

inline size_t dtype_itemsize(DType d) {
  switch (d) {
    case DType::F32: case DType::I32: case DType::U32: return 4;
    case DType::F64: case DType::I64: case DType::U64: return 8;
    default: return 1;
  }
}

struct Value;
using List = std::vector<Value>;
using MapItems = std::vector<std::pair<Value, Value>>;

// N-dimensional array. `data` may BORROW the request buffer (valid for the
// duration of the call) or OWN a copy (`owned` non-empty).  Returning a
// borrowed array from a function is fine: encode() copies it to the wire.
struct NdArray {
  DType dtype = DType::F64;
  std::vector<uint64_t> shape;
  const uint8_t* data = nullptr;
  std::vector<uint8_t> owned;

  size_t size() const {
    size_t n = 1;
    for (uint64_t d : shape) n *= static_cast<size_t>(d);
    return n;
  }
  size_t nbytes() const { return size() * dtype_itemsize(dtype); }
  const uint8_t* ptr() const { return owned.empty() ? data : owned.data(); }

  template <typename T> const T* as() const {
    return reinterpret_cast<const T*>(ptr());
  }
  template <typename T> static NdArray make(DType dt, std::vector<uint64_t> shp,
                                            const T* src = nullptr) {
    NdArray a;
    a.dtype = dt;
    a.shape = std::move(shp);
    a.owned.resize(a.nbytes());
    if (src) std::memcpy(a.owned.data(), src, a.nbytes());
    return a;
  }
  template <typename T> T* mutable_data() {
    return reinterpret_cast<T*>(owned.data());
  }
};

struct Value {
  Kind kind = Kind::Nil;
  bool b = false;
  int64_t i = 0;
  double d = 0.0;
  std::string s;       // Str and Bytes both live here
  List list;
  MapItems map;
  NdArray arr;

  Value() = default;
  explicit Value(bool v) : kind(Kind::Bool), b(v) {}
  explicit Value(int64_t v) : kind(Kind::Int), i(v) {}
  explicit Value(int v) : kind(Kind::Int), i(v) {}
  explicit Value(double v) : kind(Kind::Float), d(v) {}
  explicit Value(const char* v) : kind(Kind::Str), s(v) {}
  explicit Value(std::string v) : kind(Kind::Str), s(std::move(v)) {}
  explicit Value(List v) : kind(Kind::List), list(std::move(v)) {}
  explicit Value(MapItems v) : kind(Kind::Map), map(std::move(v)) {}
  explicit Value(NdArray v) : kind(Kind::Array), arr(std::move(v)) {}

  static Value bytes(std::string v) {
    Value out;
    out.kind = Kind::Bytes;
    out.s = std::move(v);
    return out;
  }

  bool is_nil() const { return kind == Kind::Nil; }
  bool as_bool() const { require(Kind::Bool, "bool"); return b; }
  int64_t as_int() const {
    if (kind == Kind::Float) return static_cast<int64_t>(d);
    require(Kind::Int, "int");
    return i;
  }
  double as_float() const {
    if (kind == Kind::Int) return static_cast<double>(i);
    require(Kind::Float, "float");
    return d;
  }
  const std::string& as_str() const { require(Kind::Str, "str"); return s; }
  const std::string& as_bytes() const { require(Kind::Bytes, "bytes"); return s; }
  const List& as_list() const { require(Kind::List, "list"); return list; }
  const MapItems& as_map() const { require(Kind::Map, "map"); return map; }
  const NdArray& as_array() const { require(Kind::Array, "ndarray"); return arr; }

  const Value* find(const std::string& key) const {
    require(Kind::Map, "map");
    for (const auto& kv : map)
      if (kv.first.kind == Kind::Str && kv.first.s == key) return &kv.second;
    return nullptr;
  }

 private:
  void require(Kind k, const char* what) const {
    if (kind != k)
      throw std::runtime_error(std::string("xl::Value: expected ") + what +
                               ", got kind " + std::to_string(int(kind)));
  }
};

// ---------------------------------------------------------------- encoding

inline void _put_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(v & 0xff); out.push_back((v >> 8) & 0xff);
  out.push_back((v >> 16) & 0xff); out.push_back((v >> 24) & 0xff);
}
inline uint32_t _checked_len(size_t n, const char* what) {
  if (n > 0xffffffffull)
    throw std::runtime_error(std::string(what) +
                             " exceeds the u32 wire length limit");
  return static_cast<uint32_t>(n);
}
inline void _put_u64(std::vector<uint8_t>& out, uint64_t v) {
  for (int k = 0; k < 8; ++k) out.push_back((v >> (8 * k)) & 0xff);
}

inline void encode_into(const Value& v, std::vector<uint8_t>& out) {
  switch (v.kind) {
    case Kind::Nil: out.push_back('N'); break;
    case Kind::Bool: out.push_back(v.b ? 'T' : 'F'); break;
    case Kind::Int: {
      out.push_back('i');
      uint64_t u; std::memcpy(&u, &v.i, 8); _put_u64(out, u);
      break;
    }
    case Kind::Float: {
      out.push_back('d');
      uint64_t u; std::memcpy(&u, &v.d, 8); _put_u64(out, u);
      break;
    }
    case Kind::Str: case Kind::Bytes: {
      out.push_back(v.kind == Kind::Str ? 's' : 'b');
      _put_u32(out, _checked_len(v.s.size(), "str/bytes"));
      out.insert(out.end(), v.s.begin(), v.s.end());
      break;
    }
    case Kind::List: {
      out.push_back('l');
      _put_u32(out, _checked_len(v.list.size(), "list"));
      for (const Value& it : v.list) encode_into(it, out);
      break;
    }
    case Kind::Map: {
      out.push_back('m');
      _put_u32(out, _checked_len(v.map.size(), "map"));
      for (const auto& kv : v.map) {
        encode_into(kv.first, out);
        encode_into(kv.second, out);
      }
      break;
    }
    case Kind::Array: {
      out.push_back('a');
      out.push_back(static_cast<uint8_t>(v.arr.dtype));
      out.push_back(static_cast<uint8_t>(v.arr.shape.size()));
      for (uint64_t dim : v.arr.shape) _put_u64(out, dim);
      const uint8_t* p = v.arr.ptr();
      out.insert(out.end(), p, p + v.arr.nbytes());
      break;
    }
  }
}

inline std::vector<uint8_t> encode(const Value& v) {
  std::vector<uint8_t> out;
  encode_into(v, out);
  return out;
}

// ---------------------------------------------------------------- decoding

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  uint8_t u8() {
    if (p >= end) throw std::runtime_error("xl decode: truncated");
    return *p++;
  }
  uint32_t u32() {
    if (end - p < 4) throw std::runtime_error("xl decode: truncated");
    uint32_t v = p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
    p += 4;
    return v;
  }
  uint64_t u64() {
    if (end - p < 8) throw std::runtime_error("xl decode: truncated");
    uint64_t v = 0;
    for (int k = 0; k < 8; ++k) v |= uint64_t(p[k]) << (8 * k);
    p += 8;
    return v;
  }
  const uint8_t* raw(size_t n) {
    if (static_cast<size_t>(end - p) < n)
      throw std::runtime_error("xl decode: truncated");
    const uint8_t* q = p;
    p += n;
    return q;
  }
};

// Arrays borrow the input buffer: valid for the lifetime of the request.
inline Value decode_one(Cursor& c) {
  uint8_t tag = c.u8();
  switch (tag) {
    case 'N': return Value();
    case 'T': return Value(true);
    case 'F': return Value(false);
    case 'i': {
      uint64_t u = c.u64();
      int64_t i; std::memcpy(&i, &u, 8);
      return Value(i);
    }
    case 'd': {
      uint64_t u = c.u64();
      double d; std::memcpy(&d, &u, 8);
      return Value(d);
    }
    case 's': case 'b': {
      uint32_t n = c.u32();
      const uint8_t* q = c.raw(n);
      std::string s(reinterpret_cast<const char*>(q), n);
      return tag == 's' ? Value(std::move(s)) : Value::bytes(std::move(s));
    }
    case 'l': {
      uint32_t n = c.u32();
      List items;
      items.reserve(n);
      for (uint32_t k = 0; k < n; ++k) items.push_back(decode_one(c));
      return Value(std::move(items));
    }
    case 'm': {
      uint32_t n = c.u32();
      MapItems items;
      items.reserve(n);
      for (uint32_t k = 0; k < n; ++k) {
        Value key = decode_one(c);
        Value val = decode_one(c);
        items.emplace_back(std::move(key), std::move(val));
      }
      return Value(std::move(items));
    }
    case 'a': {
      NdArray a;
      a.dtype = static_cast<DType>(c.u8());
      uint8_t nd = c.u8();
      a.shape.resize(nd);
      for (uint8_t k = 0; k < nd; ++k) a.shape[k] = c.u64();
      const uint8_t* p = c.raw(a.nbytes());
      // Borrow only when the wire offset happens to be aligned for the
      // dtype; otherwise copy so NdArray::as<T>() typed loads are legal.
      if (reinterpret_cast<uintptr_t>(p) % dtype_itemsize(a.dtype) == 0) {
        a.data = p;
      } else {
        a.owned.assign(p, p + a.nbytes());
      }
      return Value(std::move(a));
    }
    default:
      throw std::runtime_error("xl decode: bad tag " + std::to_string(tag));
  }
}

inline Value decode(const uint8_t* buf, size_t len) {
  Cursor c{buf, buf + len};
  return decode_one(c);
}

// ---------------------------------------------------------------- registry

struct Actor {
  virtual ~Actor() = default;
  virtual Value call(const std::string& method,
                     const std::vector<Value>& args) = 0;
};

using Fn = std::function<Value(const std::vector<Value>&)>;
using ActorFactory =
    std::function<std::unique_ptr<Actor>(const std::vector<Value>&)>;

struct Registry {
  std::map<std::string, Fn> fns;
  std::map<std::string, ActorFactory> actors;
  static Registry& inst() {
    static Registry r;
    return r;
  }
};

}  // namespace xl

#define XL_FUNC(fn)                                                     \
  static const bool _xl_reg_fn_##fn =                                   \
      (xl::Registry::inst().fns[#fn] = (fn), true);

#define XL_FUNC_NAMED(name, fn)                                         \
  static const bool _xl_reg_fn_named_##fn =                             \
      (xl::Registry::inst().fns[name] = (fn), true);

#define XL_ACTOR(Cls)                                                   \
  static const bool _xl_reg_actor_##Cls =                               \
      (xl::Registry::inst().actors[#Cls] =                              \
           [](const std::vector<xl::Value>& a) {                        \
             return std::unique_ptr<xl::Actor>(new Cls(a));             \
           },                                                           \
       true);

// Emits the stable C ABI.  Use exactly once per shared library.
#define XL_MODULE()                                                     \
  extern "C" {                                                          \
  static int _xl_run(const char* what,                                  \
                     const std::function<xl::Value()>& body,            \
                     unsigned char** out, unsigned long long* out_len,  \
                     char** err) {                                      \
    try {                                                               \
      std::vector<uint8_t> enc = xl::encode(body());                   \
      *out = static_cast<unsigned char*>(std::malloc(enc.size()));     \
      if (!enc.empty()) std::memcpy(*out, enc.data(), enc.size());     \
      *out_len = enc.size();                                            \
      return 0;                                                         \
    } catch (const std::exception& e) {                                 \
      std::string msg = std::string(what) + ": " + e.what();            \
      *err = static_cast<char*>(std::malloc(msg.size() + 1));          \
      std::memcpy(*err, msg.c_str(), msg.size() + 1);                  \
      return 1;                                                         \
    }                                                                   \
  }                                                                     \
  static std::vector<xl::Value> _xl_args(const unsigned char* in,       \
                                         unsigned long long in_len) {   \
    xl::Value v = xl::decode(in, in_len);                               \
    return v.as_list();                                                 \
  }                                                                     \
  int xl_invoke(const char* name, const unsigned char* in,              \
                unsigned long long in_len, unsigned char** out,         \
                unsigned long long* out_len, char** err) {              \
    auto it = xl::Registry::inst().fns.find(name);                      \
    if (it == xl::Registry::inst().fns.end()) {                         \
      std::string msg = std::string("no cross-language function '") +   \
                        name + "' registered in this library";          \
      *err = static_cast<char*>(std::malloc(msg.size() + 1));          \
      std::memcpy(*err, msg.c_str(), msg.size() + 1);                  \
      return 2;                                                         \
    }                                                                   \
    return _xl_run(name, [&] { return it->second(_xl_args(in, in_len)); }, \
                   out, out_len, err);                                  \
  }                                                                     \
  void* xl_actor_new(const char* cls, const unsigned char* in,          \
                     unsigned long long in_len, char** err) {           \
    try {                                                               \
      auto it = xl::Registry::inst().actors.find(cls);                  \
      if (it == xl::Registry::inst().actors.end())                      \
        throw std::runtime_error(                                       \
            std::string("no cross-language actor class '") + cls +      \
            "' registered in this library");                            \
      return it->second(_xl_args(in, in_len)).release();                \
    } catch (const std::exception& e) {                                 \
      std::string msg = std::string(cls) + ": " + e.what();             \
      *err = static_cast<char*>(std::malloc(msg.size() + 1));          \
      std::memcpy(*err, msg.c_str(), msg.size() + 1);                  \
      return nullptr;                                                   \
    }                                                                   \
  }                                                                     \
  int xl_actor_invoke(void* handle, const char* method,                 \
                      const unsigned char* in, unsigned long long in_len, \
                      unsigned char** out, unsigned long long* out_len, \
                      char** err) {                                     \
    xl::Actor* a = static_cast<xl::Actor*>(handle);                     \
    return _xl_run(method,                                              \
                   [&] { return a->call(method, _xl_args(in, in_len)); }, \
                   out, out_len, err);                                  \
  }                                                                     \
  void xl_actor_del(void* handle) {                                     \
    delete static_cast<xl::Actor*>(handle);                             \
  }                                                                     \
  void xl_free(void* p) { std::free(p); }                               \
  const char* xl_manifest() {                                           \
    static std::string m = [] {                                         \
      std::string s;                                                    \
      for (const auto& kv : xl::Registry::inst().fns)                   \
        s += "fn " + kv.first + "\n";                                   \
      for (const auto& kv : xl::Registry::inst().actors)                \
        s += "actor " + kv.first + "\n";                                \
      return s;                                                         \
    }();                                                                \
    return m.c_str();                                                   \
  }                                                                     \
  }  /* extern "C" */
