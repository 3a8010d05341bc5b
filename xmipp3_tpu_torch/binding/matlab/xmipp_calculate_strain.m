function [newim, strain, localrot] = xmipp_calculate_strain(fn1, fn2, fnmask, fnroot)
%XMIPP_CALCULATE_STRAIN elastic registration of volume FN2 onto FN1 and
%local strain/rotation analysis. The reference M-file drives the MIRT
%MATLAB toolbox; here the same workflow runs through the port's Zernike3D
%volume deformation (`xmipp_torch volume_deform_sph --analyzeStrain`),
%which fits a smooth displacement field and derives strain = |det(sym
%grad u)| and the local rotation from the antisymmetric part.
%
%   [newim, strain, localrot] = xmipp_calculate_strain(fn1, fn2, fnmask, fnroot)
cmd = sprintf(['xmipp_torch volume_deform_sph -i "%s" -r "%s" -o "%s_deformed.vol"' ...
               ' --oroot "%s" --analyzeStrain'], fn2, fn1, fnroot, fnroot);
[status, msg] = system(cmd);
if status ~= 0
    error('xmipp_calculate_strain: volume_deform_sph failed: %s', msg);
end
newim = xmipp_read([fnroot '_deformed.vol']);
strain = xmipp_read([fnroot '_strain.vol']);
localrot = xmipp_read([fnroot '_rotation.vol']);
if nargin >= 3 && ~isempty(fnmask)
    mask = xmipp_read(fnmask);
    strain = strain .* (mask > 0);
    localrot = localrot .* (mask > 0);
end
end
