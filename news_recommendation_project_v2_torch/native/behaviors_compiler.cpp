// Native behaviors compiler: MIND history/impression strings -> flat index
// arrays, the C++ core of news_recommendation_project_v2_torch.data.compiler
// with the numpy path's semantics: first-appearance id assignment that takes
// each row's history tokens, then its impression tokens; "NewsID-{0,1}" labels
// split at the LAST '-'; rows without history contribute no history row.
//
// One pass over the strings with an interned string table. Exposed as
// _nrtorch_native.compile_behaviors, which returns the news ids as a list of
// str and each index array as little-endian bytes (the Python wrapper reads
// them with np.frombuffer). Plain CPython C API: no pybind11 or numpy headers.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Compiled {
  std::deque<std::string> news_list;  // deque: elements never relocate
  std::vector<int32_t> imp_rev, imp_row, imp_lens;
  std::vector<int32_t> hist_rev, hist_row, hist_lens, hist_row_index;
  std::vector<int8_t> labels;
  bool label_present = false;
};

// Interned string table. The map's string_view keys point INTO the owned
// std::string elements of a std::deque — a deque never relocates elements on
// growth, so the views stay valid (a vector<std::string> would relocate SSO
// strings on reallocation and dangle every key).
class StringTable {
 public:
  int32_t intern(std::string_view token, std::deque<std::string>& out) {
    auto it = map_.find(token);
    if (it != map_.end()) return it->second;
    out.emplace_back(token);
    int32_t id = static_cast<int32_t>(out.size() - 1);
    map_.emplace(std::string_view(out.back()), id);
    return id;
  }

 private:
  struct Hash {
    using is_transparent = void;
    size_t operator()(std::string_view s) const noexcept {
      return std::hash<std::string_view>{}(s);
    }
  };
  struct Eq {
    using is_transparent = void;
    bool operator()(std::string_view a, std::string_view b) const noexcept {
      return a == b;
    }
  };
  std::unordered_map<std::string_view, int32_t, Hash, Eq> map_;
};

// Matches Python str.split() on ASCII whitespace (space/\t/\n/\r/\v/\f).
// MIND ids are ASCII; Unicode whitespace separators would still diverge, but
// they cannot appear in TSV-sourced fields.
inline bool is_space(char c) {
  return std::isspace(static_cast<unsigned char>(c)) != 0;
}

void for_each_token(std::string_view row, auto&& fn) {
  size_t pos = 0;
  while (pos < row.size()) {
    while (pos < row.size() && is_space(row[pos])) ++pos;
    size_t end = pos;
    while (end < row.size() && !is_space(row[end])) ++end;
    if (end > pos) fn(row.substr(pos, end - pos));
    pos = end;
  }
}

bool get_utf8(PyObject* obj, std::string_view* out) {
  if (!PyUnicode_Check(obj)) return false;
  Py_ssize_t size = 0;
  const char* data = PyUnicode_AsUTF8AndSize(obj, &size);
  if (data == nullptr) return false;
  *out = std::string_view(data, static_cast<size_t>(size));
  return true;
}

PyObject* bytes_from(const void* data, size_t nbytes) {
  return PyBytes_FromStringAndSize(static_cast<const char*>(data),
                                   static_cast<Py_ssize_t>(nbytes));
}

PyObject* compile_behaviors(PyObject*, PyObject* args) {
  PyObject* imps;
  PyObject* hists;
  if (!PyArg_ParseTuple(args, "OO", &imps, &hists)) return nullptr;
  if (!PyList_Check(imps) || !PyList_Check(hists)) {
    PyErr_SetString(PyExc_TypeError, "expected (list, list)");
    return nullptr;
  }
  Py_ssize_t n = PyList_Size(imps);
  if (n == 0) {
    PyErr_SetString(PyExc_AssertionError, "No impressions given");
    return nullptr;
  }
  if (PyList_Size(hists) != n) {
    PyErr_SetString(PyExc_ValueError, "history/impressions row-count mismatch");
    return nullptr;
  }

  Compiled c;
  StringTable table;

  {
    std::string_view first;
    if (!get_utf8(PyList_GET_ITEM(imps, 0), &first)) {
      PyErr_SetString(PyExc_TypeError, "impressions must be str");
      return nullptr;
    }
    c.label_present = first.find('-') != std::string_view::npos;
  }

  for (Py_ssize_t i = 0; i < n; ++i) {
    // History: None / NaN-float / empty string all mean "no history"
    // (the numpy path's _is_missing).
    PyObject* h = PyList_GET_ITEM(hists, i);
    std::string_view hrow;
    bool has_hist = false;
    if (PyFloat_Check(h)) {
      // Only NaN floats mean "missing" (mirrors the Python path's _is_missing);
      // any other float is a type error there too.
      if (!std::isnan(PyFloat_AS_DOUBLE(h))) {
        PyErr_SetString(PyExc_TypeError, "history must be str/None/NaN");
        return nullptr;
      }
    } else if (h != Py_None) {
      if (!get_utf8(h, &hrow)) {
        PyErr_SetString(PyExc_TypeError, "history must be str/None/NaN");
        return nullptr;
      }
      // Strip to detect whitespace-only rows.
      size_t a = hrow.find_first_not_of(" \t\n\r\v\f");
      has_hist = a != std::string_view::npos;
    }
    if (has_hist) {
      int32_t count = 0;
      for_each_token(hrow, [&](std::string_view tok) {
        c.hist_rev.push_back(table.intern(tok, c.news_list));
        c.hist_row.push_back(static_cast<int32_t>(c.hist_lens.size()));
        ++count;
      });
      c.hist_lens.push_back(count);
      c.hist_row_index.push_back(static_cast<int32_t>(i));
    }

    std::string_view irow;
    if (!get_utf8(PyList_GET_ITEM(imps, i), &irow)) {
      PyErr_SetString(PyExc_TypeError, "impressions must be str");
      return nullptr;
    }
    int32_t count = 0;
    bool bad_label = false;
    for_each_token(irow, [&](std::string_view tok) {
      std::string_view news = tok;
      if (c.label_present) {
        size_t dash = tok.rfind('-');
        if (dash == std::string_view::npos || dash + 2 != tok.size() ||
            (tok[dash + 1] != '0' && tok[dash + 1] != '1')) {
          bad_label = true;
          return;
        }
        news = tok.substr(0, dash);
        c.labels.push_back(tok[dash + 1] == '1' ? 1 : 0);
      }
      c.imp_rev.push_back(table.intern(news, c.news_list));
      c.imp_row.push_back(static_cast<int32_t>(i));
      ++count;
    });
    if (bad_label) {
      PyErr_Format(PyExc_ValueError, "malformed labeled token in row %zd", i);
      return nullptr;
    }
    c.imp_lens.push_back(count);
  }

  PyObject* news = PyList_New(static_cast<Py_ssize_t>(c.news_list.size()));
  if (news == nullptr) return nullptr;
  for (size_t j = 0; j < c.news_list.size(); ++j) {
    PyObject* s = PyUnicode_FromStringAndSize(
        c.news_list[j].data(), static_cast<Py_ssize_t>(c.news_list[j].size()));
    if (s == nullptr) {
      Py_DECREF(news);
      return nullptr;
    }
    PyList_SET_ITEM(news, static_cast<Py_ssize_t>(j), s);
  }

  auto vec_bytes = [](const auto& v) {
    using T = typename std::decay_t<decltype(v)>::value_type;
    return bytes_from(v.data(), v.size() * sizeof(T));
  };
  PyObject* labels_obj =
      c.label_present ? vec_bytes(c.labels) : (Py_INCREF(Py_None), Py_None);

  return Py_BuildValue(
      "(N N N N N N N N N i)", news, vec_bytes(c.imp_rev), vec_bytes(c.imp_row),
      vec_bytes(c.imp_lens), vec_bytes(c.hist_rev), vec_bytes(c.hist_row),
      vec_bytes(c.hist_lens), vec_bytes(c.hist_row_index), labels_obj,
      c.label_present ? 1 : 0);
}

PyMethodDef methods[] = {
    {"compile_behaviors", compile_behaviors, METH_VARARGS,
     "Compile MIND behavior strings into flat index arrays."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_nrtorch_native",
    "Native behaviors compiler of news_recommendation_project_v2_torch.", -1,
    methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__nrtorch_native(void) { return PyModule_Create(&moduledef); }
